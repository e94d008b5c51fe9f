"""Perf hill-climb: record tagged probe variants of a cell and
report the roofline-term deltas against the recorded baseline.

Port of ``src/repro/launch/perf.py`` over ``launch.probes``, whose mode
every variant takes: the sharded program on the dry-run's 16×16 mesh by
default (``--multi-pod``, ``--smoke`` as there), the data-only one with
``--pex-spmd [--ranks N]``:

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --arch deepseek-v2-236b --shape train_4k --variant moe_local_dispatch

Variants (composable with +):
  baseline            — the port's default: PexSpec() (the priced
                        gram/direct pick), one global MoE dispatch group
  pex_off             — instrumentation disabled (the reference floor)
  pex_gram            — every dense stat on the gram form
  pex_factorized      — paper §4's formula applied mechanically (an upper
                        bound on (B, S, p) inputs)
  moe_local_dispatch  — grouped dispatch: each of 16 groups of examples
                        scatters its own tokens (``MoeCfg.dispatch_groups``;
                        on the sharded record, one group a data rank)
  moe_cf1             — MoE capacity factor 1.0
  remat_dots          — ``remat_policy="dots"``: each block keeps its
                        2-D-weight products (the transformer family)
  no_remat            — ``remat=False``: every activation kept
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from typing import Optional

from repro_torch.launch.probes import add_mode_args, mode_kw, run_probes

VARIANTS = ("baseline", "pex_off", "pex_gram", "pex_factorized",
            "moe_local_dispatch", "moe_cf1", "remat_dots", "no_remat")


def apply_variant(cfg, name: str):
    """``cfg`` under one config variant (the pex_* variants change the
    spec, not the config)."""
    if name in ("baseline", "pex_off", "pex_gram", "pex_factorized"):
        return cfg
    if name in ("moe_local_dispatch", "moe_cf1"):
        if getattr(cfg, "moe", None) is None:
            raise ValueError(f"variant {name!r} needs an MoE config")
        kw = {"dispatch_groups": 16} if name == "moe_local_dispatch" \
            else {"capacity_factor": 1.0}
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **kw))
    if name == "remat_dots":
        if not hasattr(cfg, "remat_policy"):
            raise ValueError(f"variant {name!r} needs a config with a "
                             f"remat_policy (the transformer family)")
        return dataclasses.replace(cfg, remat_policy="dots")
    if name == "no_remat":
        return dataclasses.replace(cfg, remat=False)
    raise ValueError(f"unknown variant {name!r}; known: {VARIANTS}")


def spec_for(names):
    """The ``PexSpec`` of a variant list."""
    from repro_torch.core.taps import DISABLED, PexSpec
    if "pex_off" in names:
        return DISABLED
    if "pex_gram" in names:
        return PexSpec(method="gram")
    if "pex_factorized" in names:
        return PexSpec(method="factorized")
    return PexSpec()


def run_variant(arch_id: str, shape_name: str, variant: str, *,
                ranks: Optional[int] = None, multi_pod: bool = False,
                smoke: bool = False, cfg=None, out_dir="build/perf",
                verbose: bool = True):
    """The roofline of one variant of a cell (``run_probes`` on the
    varied config and spec): the sharded program on the dry-run's mesh by
    default, the ``--pex-spmd`` one over ``ranks`` data ranks where
    given."""
    from repro_torch.models import registry
    names = variant.split("+")
    aspec = registry.get(arch_id)
    cfg = cfg if cfg is not None else (aspec.smoke() if smoke
                                       else aspec.full())
    for n in names:
        cfg = apply_variant(cfg, n)
    return run_probes(arch_id, shape_name, ranks, multi_pod=multi_pod,
                      smoke=smoke, cfg=cfg, spec=spec_for(names),
                      out_dir=out_dir, tag=variant.replace("+", "_"),
                      verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True,
                    help="'+'-joined list, e.g. moe_local_dispatch+pex_gram")
    add_mode_args(ap)
    ap.add_argument("--out", default="build/perf")
    args = ap.parse_args(argv)
    try:
        d = run_variant(args.arch, args.shape, args.variant,
                        out_dir=args.out, **mode_kw(args))
    except ValueError as e:
        raise SystemExit(f"perf: {e}")
    base_path = os.path.join("build", "roofline",
                             f"{args.arch}__{args.shape}.json")
    if os.path.exists(base_path) and d is not None:
        with open(base_path) as f:
            b = json.load(f)
        print("\nΔ vs baseline:")
        for k in ("t_compute", "t_memory", "t_collective"):
            print(f"  {k:13s} {b[k] * 1e3:12.1f} → {d[k] * 1e3:12.1f} ms  "
                  f"({d[k] / max(b[k], 1e-12):.3f}x)")
        print(f"  useful_ratio  {b['useful_ratio']:.3f} → "
              f"{d['useful_ratio']:.3f}")
        print(f"  mfu_bound     {b['mfu_bound']:.4f} → {d['mfu_bound']:.4f}")


if __name__ == "__main__":
    main()
