"""Roofline probe runner: the roofline of a cell from 1–3-layer records.

Port of ``src/repro/launch/probes.py``. The reference compiled each arch's
1–3-layer *unrolled* probe variants (XLA's cost analysis counts a loop
body once) and extrapolated their flops, bytes and collective bytes to the
full depth. The port's layers run in a Python loop, so a record on
``meta`` tensors counts every layer: a full-depth record is exact. The
probe extrapolation stays as the fast path (each record is a fraction of
the full one), and ``full_record=True`` also records the full depth and
reports the probes' error against it and the host seconds of both
(``probe_s``, ``full_s``): what the fast path saves.

The records are the reference's: the sharded program (``dryrun``'s
default mode, the reference's GSPMD one) on the dry-run's production mesh,
16×16 or 2×16×16 with ``--multi-pod`` ((4, 4) and (2, 4, 4) under
``--smoke``), rank 0's own work scaled to the mesh's devices; the
collective bytes by the reference's kinds (``coll_breakdown``) and by
``kind@axes`` (``coll_by_axis``). ``--pex-spmd --ranks N`` records the
data-only ``dist.pex`` program instead.

Each arch's probe depths and their combination are the reference's
(``ArchSpec.probes`` / ``combine`` of its configs): two probes and a line
for a homogeneous stack (gemma2 in whole local/global periods, deepseek
past its dense prefix), three for zamba2's Mamba and shared blocks and for
seamless's encoder and decoder — with the target depth read from the
config, so a cut config extrapolates to its own depth.

    PYTHONPATH=src python -m repro_torch.launch.probes --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--full-record] [--out build/roofline]
    PYTHONPATH=src python -m repro_torch.launch.probes --pex-spmd \\
        --ranks 256 --arch llama3.2-1b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import (COLL_KEYS, axis_metrics,
                                           build_roofline, mfu, model_flops,
                                           n_active_for, probe_metrics)


def lin2(small_n: int = 1, big_n: int = 2):
    """metric(L) = a + b·L from two probes, at the config's depth. Clamped
    to ≥ max(probe values): extrapolation noise (near-equal probes
    dominated by constant terms) must not go negative."""
    def combine(ms: List[dict], cfg) -> dict:
        out = {}
        for k in ms[0]:
            b = (ms[1][k] - ms[0][k]) / (big_n - small_n)
            a = ms[0][k] - b * small_n
            out[k] = max(a + b * cfg.n_layers, ms[0][k], ms[1][k], 0.0)
        return out
    return combine


def zamba2_depths(cfg) -> tuple:
    """One group of ``share_every`` = k Mamba blocks and the shared block;
    two groups; one group and k/2 tail blocks (k = 6: 6, 12 and 9 layers,
    the reference's probes)."""
    k = cfg.share_every
    return (k, 2 * k, k + max(1, k // 2))


def zamba2_combine(ms: List[dict], cfg) -> dict:
    """The three probes of :func:`zamba2_depths` → the config's groups of
    k and its tail."""
    k = cfg.share_every
    r = max(1, k // 2)
    groups, tail = divmod(cfg.n_layers, k)
    out = {}
    for key in ms[0]:
        a, b, c = ms[0][key], ms[1][key], ms[2][key]
        mamba = (c - a) / r
        shared = (b - a) - k * mamba
        c0 = a - k * mamba - shared
        out[key] = max(*(m[key] for m in ms), 0.0,
                       c0 + groups * (k * mamba + shared) + tail * mamba)
    return out


def seamless_combine(ms: List[dict], cfg) -> dict:
    """Probes of (1, 1), (2, 1) and (1, 2) encoder and decoder layers →
    the config's ``n_enc`` and ``n_dec``."""
    out = {}
    for k in ms[0]:
        a, b, c = ms[0][k], ms[1][k], ms[2][k]
        enc, dec = b - a, c - a
        c0 = a - enc - dec
        out[k] = max(*(m[k] for m in ms), 0.0,
                     c0 + cfg.n_enc * enc + cfg.n_dec * dec)
    return out


#: {arch: (probe depths, or a function of the config giving them,
#: combine)}
PROBES = {
    "llama3.2-1b": ((1, 2), lin2()),
    "qwen2-7b": ((1, 2), lin2()),
    "qwen2-vl-7b": ((1, 2), lin2()),
    "minitron-4b": ((1, 2), lin2()),
    "phi3.5-moe": ((1, 2), lin2()),
    "rwkv6-3b": ((1, 2), lin2()),
    "gemma2-9b": ((2, 4), lin2(2, 4)),        # whole local/global periods
    "deepseek-v2-236b": ((2, 3), lin2(2, 3)),  # the dense prefix + MoE
    "zamba2-7b": (zamba2_depths, zamba2_combine),
    "seamless-m4t-medium": (((1, 1), (2, 1), (1, 2)), seamless_combine),
}


def probe_configs(arch_id: str, cfg) -> list:
    """``cfg`` at each probe depth of ``arch_id``."""
    depths, _ = PROBES[arch_id]
    if callable(depths):
        depths = depths(cfg)
    if arch_id == "seamless-m4t-medium":
        return [dataclasses.replace(cfg, n_enc=e, n_dec=d)
                for e, d in depths]
    return [dataclasses.replace(cfg, n_layers=n) for n in depths]


def extrapolate(arch_id: str, metrics: List[dict], cfg) -> dict:
    """The probes' ``metrics`` at ``cfg``'s depth."""
    return PROBES[arch_id][1](metrics, cfg)


def _record_metrics(arch_id, shape_name, ranks, cfg, multi_pod, smoke,
                    **kw):
    """(CellResult, metrics) of one record of ``cfg``: ``probe_metrics``
    and, by ``kind@axes``, ``axis_metrics``. The sharded program on the
    dry-run's mesh where ``ranks`` is None, else the ``--pex-spmd``
    record over ``ranks`` data ranks."""
    if ranks is None:
        res, tr = dryrun.lower_sharded(arch_id, shape_name, multi_pod,
                                       smoke=smoke, cfg_override=cfg, **kw)
    else:
        res, tr = dryrun.lower_cell(arch_id, shape_name, ranks,
                                    cfg_override=cfg, **kw)
    if not res.ok:
        raise RuntimeError(f"{arch_id} × {shape_name}: {res.reason}"
                           f"{res.error}")
    return res, {**probe_metrics(tr), **axis_metrics(tr)}


def mesh_of(ranks: Optional[int], multi_pod: bool = False,
            smoke: bool = False):
    """(name, chips) of the recorded world: the dry-run's mesh of the
    sharded mode ("16x16", "2x16x16"; "4x4", "2x4x4" under ``smoke``), or
    ``ranks`` data ranks."""
    if ranks is not None:
        return f"{ranks}", ranks
    shape = (dryrun.SMOKE_MESHES if smoke else dryrun.MESHES)[multi_pod][0]
    return "x".join(map(str, shape)), math.prod(shape)


def run_probes(arch_id: str, shape_name: str, ranks: Optional[int] = None,
               *, multi_pod: bool = False, smoke: bool = False,
               cfg=None, spec=None, consumers=None,
               out_dir: Optional[str] = "build/roofline",
               dryrun_dir: str = "build/dryrun", tag: str = "",
               full_record: bool = False, verbose: bool = True,
               shape=None) -> Optional[Dict]:
    """The roofline of one cell from its probe records (and, with
    ``full_record``, the full record beside them); written to
    ``out_dir/<arch>__<shape>[__tag].json``.

    By default every record is the sharded program on the dry-run's mesh
    (``dryrun.lower_sharded``, rank 0's own work; ``multi_pod`` and
    ``smoke`` pick the mesh as the dry-run does), the reference's GSPMD
    probes; the peak and the parameter count come from the dry-run's
    sharded cell ``<arch>__<shape>__<mesh>.json``. ``ranks=N`` records
    the ``--pex-spmd`` data-only program over N ranks instead (its cell
    ``<arch>__<shape>__<N>.json``). Either record is one rank's; the
    roofline's whole-step metrics are it times the world's size."""
    from repro_torch.models import registry
    aspec = registry.get(arch_id)
    shp = shape if shape is not None else dryrun.shape_spec(shape_name)
    if cfg is None and shp.name in dryrun.SKIP.get(arch_id, ()):
        if verbose:
            print(f"[SKIP] {arch_id} × {shp.name}: {dryrun.SKIP_REASON}")
        return None
    cfg = cfg if cfg is not None else (aspec.smoke() if smoke
                                       else aspec.full())
    mesh, chips = mesh_of(ranks, multi_pod, smoke)
    kw = dict(spec=spec, consumers=consumers, shape=shp)
    metrics = []
    t0 = time.perf_counter()
    for i, pcfg in enumerate(probe_configs(arch_id, cfg)):
        _, m = _record_metrics(arch_id, shp.name, ranks, pcfg, multi_pod,
                               smoke, **kw)
        metrics.append(m)
        if verbose:
            print(f"  probe{i}: flops={m['flops']:.4g} "
                  f"bytes={m['bytes']:.4g} coll={m['coll_bytes']:.4g}")
    # a collective of one probe and not another is 0 bytes in the other
    keys = dict.fromkeys(k for m in metrics for k in m)
    metrics = [{k: m.get(k, 0.0) for k in keys} for m in metrics]
    per_rank = extrapolate(arch_id, metrics, cfg)
    probe_s = time.perf_counter() - t0

    peak, n_total, exact, full_s = 0.0, None, None, None
    if full_record:
        t0 = time.perf_counter()
        res, exact = _record_metrics(arch_id, shp.name, ranks, cfg,
                                     multi_pod, smoke, **kw)
        full_s = time.perf_counter() - t0
        peak, n_total = res.peak_bytes_per_dev, res.n_params
    else:
        cell = os.path.join(dryrun_dir,
                            f"{arch_id}__{shp.name}__{mesh}.json")
        if os.path.exists(cell):
            with open(cell) as f:
                d = json.load(f)
            peak, n_total = d["peak_bytes_per_dev"], d["n_params"]
    if n_total is None:
        import torch
        from repro_torch.nn.param import tree_leaves
        params = registry.family_module(aspec).init(
            cfg, torch.Generator().manual_seed(0), device="meta")
        n_total = float(sum(x.numel() for x in tree_leaves(params)))
    n_act = n_active_for(arch_id, n_total, cfg)
    glob = {k: v * chips for k, v in per_rank.items()}
    r = build_roofline(arch_id, shp.name, mesh, glob,
                       model_flops(shp, n_act), peak, chips=chips)
    d = dataclasses.asdict(r)
    d["mode"] = "sharded" if ranks is None else "pex-spmd"
    d["mfu_bound"] = mfu(r)
    d["n_active"] = n_act
    d["coll_breakdown"] = {k: glob[k] for k in COLL_KEYS}
    d["coll_by_axis"] = {k: v for k, v in glob.items() if "@" in k}
    d["probes"] = metrics
    d["per_rank"] = per_rank
    d["probe_s"] = probe_s
    if exact is not None:
        d["full_record"] = exact
        d["full_s"] = full_s
        d["probe_error"] = {k: (per_rank.get(k, 0.0) - v) / v if v else
                            per_rank.get(k, 0.0) for k, v in exact.items()}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        with open(os.path.join(out_dir,
                               f"{arch_id}__{shp.name}{suffix}.json"),
                  "w") as f:
            json.dump(d, f, indent=1)
    if verbose:
        print(f"[ROOF] {arch_id} × {shp.name} × {mesh}: "
              f"compute={r.t_compute * 1e3:.2f}ms "
              f"memory={r.t_memory * 1e3:.2f}ms "
              f"coll={r.t_collective * 1e3:.2f}ms → {r.bottleneck}-bound; "
              f"useful={r.useful_ratio:.2f} mfu_bound={d['mfu_bound']:.2f}"
              + f"; probes {probe_s:.2f} s"
              + (f", full record {full_s:.2f} s; probes vs full record "
                 f"{d['probe_error']}" if exact is not None else ""))
    return d


def add_mode_args(ap) -> None:
    """The record's mode and mesh options, shared with ``launch.perf``."""
    ap.add_argument("--pex-spmd", action="store_true",
                    help="record the data-only mesh path (dist.pex) over "
                         "--ranks instead of the sharded default")
    ap.add_argument("--ranks", type=int, default=1,
                    help="--pex-spmd: data ranks of the recorded mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs on the dry-run's smoke meshes")


def mode_kw(args) -> dict:
    """``run_probes``' mode keywords from :func:`add_mode_args`' options."""
    return dict(ranks=args.ranks if args.pex_spmd else None,
                multi_pod=args.multi_pod, smoke=args.smoke)


def main(argv=None):
    from repro_torch.configs.common import SHAPES
    from repro_torch.models import registry
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.probes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    add_mode_args(ap)
    ap.add_argument("--full-record", action="store_true",
                    help="also record the full depth and report the "
                         "probes' error against it")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="build/roofline")
    ap.add_argument("--dryrun-dir", default="build/dryrun",
                    help="where the dry-run's cells (the peak) are read")
    args = ap.parse_args(argv)
    archs = sorted(registry.ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = (list(dryrun._EXTRA_SHAPES) if args.smoke else list(SHAPES)) \
        if (args.all or not args.shape) else [args.shape]
    failures = 0
    for arch in archs:
        for shp in shapes:
            try:
                run_probes(arch, shp, tag=args.tag, out_dir=args.out,
                           dryrun_dir=args.dryrun_dir,
                           full_record=args.full_record, **mode_kw(args))
            except Exception:
                failures += 1
                print(f"[FAIL] {arch} × {shp}\n"
                      f"{traceback.format_exc()[-1500:]}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
