"""Render the dry-run and roofline tables from the JSON artifacts that
``launch.dryrun`` and ``launch.probes`` write.

Port of ``src/repro/roofline/report.py``:

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dryrun build/dryrun] [--roofline build/roofline]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ARCH_ORDER = ["qwen2-vl-7b", "zamba2-7b", "llama3.2-1b", "qwen2-7b",
              "minitron-4b", "gemma2-9b", "rwkv6-3b", "seamless-m4t-medium",
              "deepseek-v2-236b", "phi3.5-moe"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt(x, unit=""):
    if x == 0:
        return "0"
    for div, suf in [(1e15, "P"), (1e12, "T"), (1e9, "G"), (1e6, "M"),
                     (1e3, "k")]:
        if abs(x) >= div:
            return f"{x / div:.2f}{suf}{unit}"
    return f"{x:.2f}{unit}"


def _ms(x):
    return f"{x * 1e3:.2f}"


def load(d):
    out = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        with open(f) as fh:
            out[os.path.basename(f)[:-5]] = json.load(fh)
    return out


def dryrun_table(dr):
    """One row a (arch × shape × data ranks) cell of ``launch.dryrun``."""
    lines = ["| arch | shape | ranks | status | record s | params/dev | "
             "state/dev | peak/dev | fits | flops/dev | all-reduce bytes |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shp in SHAPE_ORDER:
            cells = sorted((v for v in dr.values()
                            if v.get("arch") == arch
                            and v.get("shape") == shp),
                           key=lambda v: v.get("ranks", 0))
            for d in cells:
                if not d.get("ok"):
                    lines.append(f"| {arch} | {shp} | {d.get('ranks')} | "
                                 f"{'SKIP' if d.get('skipped') else 'FAIL'}"
                                 f" | – | – | – | – | – | – | – |")
                    continue
                lines.append(
                    f"| {arch} | {shp} | {d['ranks']} | OK | "
                    f"{d['record_s']:.1f} | "
                    f"{d['param_bytes_per_dev'] / 1e9:.2f}G | "
                    f"{d['state_bytes_per_dev'] / 1e9:.2f}G | "
                    f"**{d['peak_bytes_per_dev'] / 1e9:.2f}G** | "
                    f"{'yes' if d['fits'] else 'no'} | "
                    f"{_fmt(d['flops'])} | "
                    f"{_fmt(d['coll_bytes'].get('total', 0), 'B')} |")
    return "\n".join(lines)


def roofline_table(rf, tag=""):
    lines = ["| arch | shape | compute ms | memory ms | coll ms | "
             "bottleneck | roof-frac | MODEL_FLOPS | flops | useful | "
             "MFU-bound | peak GB | next lever |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shp in SHAPE_ORDER:
            k = f"{arch}__{shp}" + (f"__{tag}" if tag else "")
            if k not in rf:
                continue
            d = rf[k]
            lines.append(
                f"| {arch} | {shp} | {_ms(d['t_compute'])} | "
                f"{_ms(d['t_memory'])} | {_ms(d['t_collective'])} | "
                f"**{d['bottleneck']}** | {d['roofline_fraction']:.2f} | "
                f"{_fmt(d['model_flops'])} | {_fmt(d['flops'])} | "
                f"{d['useful_ratio']:.2f} | {d['mfu_bound']:.3f} | "
                f"{d['peak_gb_per_dev']:.1f} | {lever(d)} |")
    return "\n".join(lines)


def lever(d) -> str:
    """One sentence: what would move the dominant term down."""
    b = d["bottleneck"]
    if b == "collective":
        return ("the gradient all-reduce: bucket the per-leaf all-reduces, "
                "overlap them with the backward, or shard the optimizer")
    if b == "memory":
        if d["useful_ratio"] < 0.5:
            return ("bytes ≫ useful: fuse the eager elementwise chains (the "
                    "apply's streams, ROADMAP.md Queue 2b row 0) and the "
                    "stat reductions")
        return "increase arithmetic intensity: larger per-card tiles / batch"
    if d["useful_ratio"] < 0.4:
        return "flops overhead (norms pass + stats): the priced gram/direct pick"
    return "near compute roof: only kernel-level tensor-core use remains"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="build/dryrun")
    ap.add_argument("--roofline", default="build/roofline")
    args = ap.parse_args(argv)
    dr = load(args.dryrun)
    rf = load(args.roofline)
    print("## Dry-run (data-only mesh, one record a cell)\n")
    print(dryrun_table(dr))
    print("\n## Roofline (H100 profile)\n")
    print(roofline_table({k: v for k, v in rf.items() if "__" in k}))


if __name__ == "__main__":
    main()
