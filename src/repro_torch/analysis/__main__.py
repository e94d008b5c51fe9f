"""``python -m repro_torch.analysis`` — lint every registered model.

Port of ``src/repro/analysis/__main__.py``. For each arch × granularity
{example, token} × consumer-set combination, run
plan analysis, tap-coverage verification, kernel-launch validation, and
the flow passes — privacy (DP dataflow over a full recorded step),
collectives (the all-reduce layout on a one-rank data mesh), determinism
(data-pipeline purity, checked once per run) — entirely on ``meta``
tensors: parameters come from the family's initializer on the ``meta``
device, batches from ``registry.make_train_batch`` at the lint shape —
no weight is materialized and no kernel runs. A guard on the kernel
library's loader enforces that. The lint shape is the reference's, B=3,
S=8.

``--full`` lints the published widths instead of the smoke configs,
``--depth ARCH=N`` cuts an arch's depth (repeatable). ``--fast`` skips the
flow passes (coverage + plan + launch only). Launch contracts are checked
against the H100's budgets (the reference's ``--backend`` has no other
value here). ``--json`` emits the findings machine-readably on
stdout (status lines move to stderr), with each arch's seconds.

``--cost`` (independent of ``--fast``) also records each non-empty
consumer set as a full training step under AdamW and runs the traffic and
cost passes on it (``--profile``, default ``h100-sxm-80gb``), then gates
the CostReports against the port's committed baseline
(``src/repro_torch/analysis/cost_baseline.json``, or ``--cost-baseline
PATH``): growth past 25% is an error. ``--write-cost-baseline`` rewrites
the baseline from the run instead, ``--cost-report PATH`` writes every
CostReport as JSON.

Exit status (``resolve_exit``): errors fail the run only under
``--fail-on-error``; warnings only under ``--fail-on-warn``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from typing import List

#: the lint shape: the reference's ShapeSpec("lint", "train", 8, 3)
BATCH, SEQ = 3, 8


def _consumer_sets(granularity: str, gen):
    from repro_torch import pex
    if granularity == "token":
        # token+GNS and token+Importance are rejected by analyze(); Noise
        # must carry an explicit sensitivity at token clip
        return [[], [pex.Norms()],
                [pex.Clip(1.0, granularity="token"),
                 pex.Noise(0.1, gen, scale=1.0)]]
    return [[], [pex.Norms()],
            [pex.Clip(1.0), pex.Noise(0.1, gen), pex.GNS()]]


class _TraceOnlyGuard:
    """Fail loudly if anything under the lint reaches the kernel library
    (a launch needs it; a trace never does)."""

    def __enter__(self):
        from repro_torch.kernels import _build
        self._build = _build
        self._orig = _build.load

        def _blocked(*a, **kw):
            raise RuntimeError(
                "pexlint is trace-only, but something tried to load the "
                "CUDA kernels; keep analyzers on meta tensors (or rerun "
                "with --no-trace-guard)")

        _build.load = _blocked
        return self

    def __exit__(self, *exc):
        self._build.load = self._orig
        return False


def lint_config(arch_id: str, *, full: bool = False, depth=None,
                batch: int = BATCH, seq: int = SEQ):
    """(spec, cfg, loss_fn, params, batch) of one arch at the lint shape:
    ``meta`` parameters from the family's initializer, a CPU batch."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.models import registry

    aspec = registry.get(arch_id)
    cfg = aspec.full() if full else aspec.smoke()
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    mod = registry.family_module(aspec)
    params = mod.init(cfg, torch.Generator().manual_seed(0), device="meta")
    shape = ShapeSpec("lint", "train", seq, batch)
    bt = registry.make_train_batch(aspec, cfg, shape, device="cpu")
    return aspec, cfg, registry.make_loss_fn_v2(aspec, cfg), params, bt


def lint_arch(arch_id: str, *, production: bool = True, gen=None,
              mesh=None, deep: bool = True, full: bool = False,
              depth=None, cost: bool = False, profile=None):
    """(findings, CostReports) for one arch across every lint
    combination."""
    import torch
    from repro_torch.analysis import findings as F
    from repro_torch.analysis.verify import verify as _verify
    from repro_torch.models import registry

    aspec, cfg, loss_fn, params, bt = lint_config(arch_id, full=full,
                                                  depth=depth)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    allow = registry.untapped_allowlist(arch_id)
    prod_cfg = aspec.full()

    found: List = []
    costs: List = []
    for gran in ("example", "token"):
        try:
            rep = _verify(
                loss_fn, params, bt, _consumer_sets(gran, gen),
                granularity=gran, allow=allow, seq=SEQ, cfg=prod_cfg,
                production=production and gran == "example",
                mesh=mesh if gran == "example" else None,
                deep=deep, determinism=False, cost=cost, profile=profile,
                model=arch_id)
        except Exception as e:  # a trace failure is itself a lint error
            found.append(F.Finding(
                "trace", F.ERROR, "trace-failure",
                f"{type(e).__name__}: {e}", model=arch_id,
                granularity=gran))
            continue
        costs.extend(rep.cost)
        per_gran: List = [
            F.Finding("coverage", F.ERROR, "untapped-leaf",
                      f"{l.path} is {l.status}", leaf=str(l.path))
            for l in rep.coverage.errors]
        per_gran += [F.Finding("launch", F.ERROR, "contract-violation", e)
                     for e in rep.launch.errors]
        per_gran += [F.Finding("coverage", F.WARNING, "stale-allow-entry",
                               f"allowlist entry {a!r} matches no "
                               f"parameter leaf of {arch_id}")
                     for a in rep.coverage.stale_allow]
        per_gran += list(rep.findings)
        found.extend(F.tag(per_gran, model=arch_id, granularity=gran))
    return found, costs


def _cost_gate(args, costs, say) -> List:
    """Baseline-gate findings for this run's CostReports; also writes the
    baseline / report files when asked."""
    import os
    from repro_torch.analysis import cost as C
    from repro_torch.analysis import findings as F

    path = args.cost_baseline or C.BASELINE_PATH
    if args.cost_report:
        with open(args.cost_report, "w") as f:
            json.dump({"profile": costs[0].profile if costs else None,
                       "reports": [c.to_json() for c in costs]}, f,
                      indent=2, sort_keys=True)
        say(f"pexcost: wrote {len(costs)} CostReport(s) to "
            f"{args.cost_report}")
    if args.write_cost_baseline:
        with open(path, "w") as f:
            json.dump(C.baseline_payload(costs), f, indent=2)
            f.write("\n")
        say(f"pexcost: wrote baseline {path}")
        return []
    if not os.path.exists(path):
        return [F.Finding(C.PASS, F.WARNING, "cost-baseline-missing",
                          f"no baseline at {path}; create it with "
                          f"--write-cost-baseline")]
    with open(path) as f:
        baseline = json.load(f)
    out = C.check_baseline(costs, baseline, full_matrix=args.all_models)
    say(f"pexcost: {len(costs)} report(s) vs {os.path.basename(path)}, "
        f"{sum(f.severity == 'error' for f in out)} regression(s)")
    return out


def registry_findings() -> List:
    """Run-level registry hygiene: allowlist keys must name archs."""
    from repro_torch.analysis import findings as F
    from repro_torch.models import registry
    return [F.Finding("coverage", F.WARNING, "unknown-allowlist-key",
                      f"UNTAPPED_ALLOWLIST key {k!r} is not a "
                      f"registered arch id")
            for k in sorted(registry.UNTAPPED_ALLOWLIST)
            if k not in registry.ARCHS]


def resolve_exit(n_errors: int, n_warnings: int, fail_on_error: bool,
                 fail_on_warn: bool) -> int:
    """Errors gate only under --fail-on-error, warnings only under
    --fail-on-warn; a warnings-only run is a pass for error-gated CI."""
    if fail_on_error and n_errors:
        return 1
    if fail_on_warn and n_warnings:
        return 1
    return 0


def _one_rank_mesh(tmp: str):
    """A one-rank gloo group through a file store (no network) and its
    ("data", "model") host mesh on the CPU."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return make_host_mesh(device_type="cpu")


def _depths(specs) -> dict:
    out = {}
    for s in specs:
        arch, _, n = s.partition("=")
        if not n.isdigit():
            raise SystemExit(f"--depth takes ARCH=N, got {s!r}")
        out[arch] = int(n)
    return out


def _lint(args, arch_ids, depths, gen, mesh, seconds, say, costs) -> List:
    """The run's findings: determinism once (unless ``--fast``), then
    every arch; each arch's seconds into ``seconds``, its CostReports
    into ``costs``."""
    from repro_torch.analysis import determinism as det
    found: List = [] if args.fast else list(det.analyze().findings)
    for aid in arch_ids:
        t1 = time.time()
        fs, cs = lint_arch(aid, production=not args.no_production, gen=gen,
                           mesh=mesh, deep=not args.fast, full=args.full,
                           depth=depths.get(aid), cost=args.cost,
                           profile=args.profile)
        found.extend(fs)
        costs.extend(cs)
        seconds[aid] = round(time.time() - t1, 2)
        n_e = sum(f.severity == "error" for f in fs)
        status = "ok" if not n_e else f"{n_e} ERROR"
        say(f"  {aid:24s} {status:12s} {seconds[aid]:5.1f}s")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="pexlint: static tap-coverage, plan, kernel-launch, "
                    "privacy-flow, collective-layout, and determinism "
                    "checks")
    ap.add_argument("--all-models", action="store_true",
                    help="lint every registered arch")
    ap.add_argument("--arch", action="append", default=[],
                    help="lint one arch id (repeatable)")
    ap.add_argument("--full", action="store_true",
                    help="lint the published widths (default: smoke)")
    ap.add_argument("--depth", action="append", default=[],
                    help="ARCH=N: cut an arch's depth (repeatable)")
    ap.add_argument("--fail-on-error", action="store_true",
                    help="exit 1 if any lint ERROR is found")
    ap.add_argument("--fail-on-warn", action="store_true",
                    help="exit 1 if any WARNING is found (errors too)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--fast", action="store_true",
                    help="coverage/plan/launch only — skip the flow passes")
    ap.add_argument("--cost", action="store_true",
                    help="run the traffic/cost passes over a full recorded "
                         "training step per consumer set (independent of "
                         "--fast)")
    ap.add_argument("--profile", default=None,
                    help="hardware profile for CostReports "
                         "(roofline.constants.PROFILES; default "
                         "h100-sxm-80gb)")
    ap.add_argument("--cost-baseline", default=None,
                    help="committed prediction baseline to gate against "
                         "(default: src/repro_torch/analysis/"
                         "cost_baseline.json)")
    ap.add_argument("--write-cost-baseline", action="store_true",
                    help="rewrite the baseline from this run instead of "
                         "gating against it")
    ap.add_argument("--cost-report", default=None,
                    help="write the full CostReport JSON artifact here")
    ap.add_argument("--no-production", action="store_true",
                    help="skip the config-derived production-shape "
                         "launch cases")
    args = ap.parse_args(argv)
    say = (lambda m: print(m, file=sys.stderr)) if args.json else print

    import torch
    from repro_torch.models import registry
    arch_ids = sorted(registry.ARCHS) if args.all_models or not args.arch \
        else args.arch
    depths = _depths(args.depth)

    t0 = time.time()
    findings: List = list(registry_findings())
    seconds, costs = {}, []
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = None if args.fast else _one_rank_mesh(tmp)
        try:
            with _TraceOnlyGuard():
                findings.extend(_lint(args, arch_ids, depths, gen, mesh,
                                      seconds, say, costs))
        finally:
            if mesh is not None:
                import torch.distributed as dist
                dist.destroy_process_group()
    if args.cost:
        findings.extend(_cost_gate(args, costs, say))

    n_err = sum(f.severity == "error" for f in findings)
    n_warn = sum(f.severity == "warning" for f in findings)
    for f in findings:
        say(f.render())
    say(f"pexlint: {len(arch_ids)} arch(s), {n_err} error(s), "
        f"{n_warn} warning(s), {time.time() - t0:.1f}s")
    if args.json:
        payload = {
            "archs": arch_ids, "errors": n_err, "warnings": n_warn,
            "elapsed_s": round(time.time() - t0, 2), "seconds": seconds,
            "full": args.full, "depths": depths, "shape": [BATCH, SEQ],
            "findings": [f.to_json() for f in findings],
        }
        if args.cost:
            payload["cost"] = [c.to_json() for c in costs]
        print(json.dumps(payload, indent=2))
    return resolve_exit(n_err, n_warn, args.fail_on_error,
                        args.fail_on_warn)


if __name__ == "__main__":
    sys.exit(main())
