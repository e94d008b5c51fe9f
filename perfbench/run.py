"""Run one cell of ``BENCHMARK.json`` once, on one GPU.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number that decided ``correct`` beside its limit; the same numbers are the
last lines of standard error. Exits non-zero, printing no result, when
CUDA or the cell's cards are missing, when the program (``src/``) is not
in the checkout, or when JAX, flax or the JAX package were loaded by the
time the window closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: top-level module names a run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs(root: pathlib.Path) -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    port's own kernel library already builds into ``build/repro_torch``);
    libraries that would load JAX by themselves are told not to."""
    base = root / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _num(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def result_line(res: dict, traced: bool, cell, device_name: str,
                count: int) -> dict:
    run = res["run"]
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.entry["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": run.peak_bytes}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        line["breakdown"] = {"device_ops": run.profile.top_ops(),
                             "idle_gaps": run.profile.idle_gaps()}
    line["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                      for k, v in res["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.lib import runner, spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port and the benchmark run "
              f"without JAX or the JAX package", file=sys.stderr)
        return 4
    line = result_line(res, bool(args.trace), cell,
                       torch.cuda.get_device_name(0), cell.chips)
    print(f"card: {power_limit()}; setup_s {res['run'].setup_s:.3f}; "
          f"steps {res['attempted']}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
