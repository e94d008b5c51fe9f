"""The readings that set a cell's limits, on the chip, in one process.

    python perfbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out <file.jsonl>]

For every seed of ``--seeds``: the program's checked first steps (the
set-up of a run, no window) against the reference's, the numbers of
``lib.check`` (the lower readings). For every seed of
``--control-seeds`` besides: the control, the reference computed with FP8
products (``reference.lowp``) put in the program's place, and each fault
of ``lib.faults.REFERENCE`` (and, in a cell that clips,
``REFERENCE_CLIP``) planted in the reference put in the program's place,
against the clean reference (the upper readings). A state left unchanged
reads 1 on the leaf gaps by their measure and needs no run. One JSON line
a reading, on standard output and in ``--out``. Exits non-zero when no
CUDA device is present.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench.lib import check, faults, runner, spec
    from perfbench.reference import lowp
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device; torch sees none",
              file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda")
    steps = cell.traffic["check_steps"]
    norms, noised = runner.wants_norms(cell), runner.wants_noise(cell)
    planted = dict(faults.REFERENCE)
    if cell.traffic["mode"] == "clip":
        planted.update(faults.REFERENCE_CLIP)
    out = open(args.out, "a") if args.out else None
    control = {int(s) for s in args.control_seeds.split(",") if s}

    def log(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        prog = runner.Program(cell, seed, device)
        got = prog.check_steps(steps)
        prog.free()
        routes = got["routes"] if got["routes"][0] else None
        ref = runner.reference(cell, seed, device, steps, routes=routes)
        log(cell=cell.name, seed=seed, kind="program",
            numbers=check.numbers(got, ref, norms, noised),
            seconds=time.perf_counter() - t0)
        if seed not in control:
            continue
        t0 = time.perf_counter()
        runs = {"control": runner.reference(cell, seed, device, steps,
                                            mm=lowp.fp8_mm)}
        for name, kwargs in planted.items():
            runs[name] = runner.reference(cell, seed, device, steps,
                                          **kwargs)
        for name, bad in runs.items():
            # the reference follows the experts chosen in its place
            ref_of = ref if routes is None else runner.reference(
                cell, seed, device, steps, routes=bad["routes"])
            log(cell=cell.name, seed=seed, kind=name,
                numbers=check.numbers(bad, ref_of, norms, noised),
                seconds=time.perf_counter() - t0)
        still = dict(ref, grad_seen=[0.0] * len(ref["grad_seen"]),
                     update=[0.0] * len(ref["update"]))
        log(cell=cell.name, seed=seed, kind="unchanged",
            numbers=check.numbers(still, ref, norms, noised))
    return 0


if __name__ == "__main__":
    sys.exit(main())
