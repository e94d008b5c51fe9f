"""Data-parallel per-example pipeline self-check.

Port of ``src/repro/dist/selfcheck.py``. Spawns ``--world-size`` ranks (one
process each; the reference forces that many host devices), runs the
tap-instrumented model through a mesh-bound ``Engine`` (the ``dist.pex``
pipeline) on a ``("data", "model")`` host mesh, and holds it against a
local ``Engine`` on the first rank: scalar loss, (B,) per-example losses,
(B, G) squared norms, summed gradients, the norms-only pass, clipped
gradients and a fused consumer plan (Clip + GNS — DESIGN.md §9), at the
reference's tolerances (f32 allclose). Every rank's parameters are checked
against the first rank's, and every rank's reduced gradients must equal
the first rank's bit for bit.

    PYTHONPATH=src python -m repro_torch.dist.selfcheck --device cpu
    PYTHONPATH=src python -m repro_torch.dist.selfcheck --device cpu \
        --world-size 4 --arch llama3.2-1b --batch 16

On the CPU the ranks use gloo (default 8 ranks). On CUDA (the default
device) the world defaults to the card count; NCCL serves a world with a
card per rank, and gloo a larger one (NCCL refuses two ranks on one
card), rank r on card r mod count. ``--batch 7`` exits 1 with the
divisibility ``ValueError``; ``--model-parallel N`` (N > 1) exits 1 with
the ``NotImplementedError`` of a model axis: the pipeline is data-parallel
only, as the reference's.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

_RAISED = {"ValueError": ValueError,
           "NotImplementedError": NotImplementedError}


def _rank(rank: int, world: int, store: str, out_dir: str, kw: dict) -> None:
    """One rank: join the group, run the checks, leave the group. Writes
    its log lines (the first rank's are the report), its verdict and any
    refusal to ``out_dir``."""
    import torch.distributed as dist

    device = torch.device(kw["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl" if world <= torch.cuda.device_count() else "gloo"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world)
    out = {"lines": [], "ok": False, "error": None}
    try:
        out["ok"] = _checks(rank, device, backend, out["lines"],
                            **{k: v for k, v in kw.items()
                               if k != "device"})
    except (ValueError, NotImplementedError) as e:
        out["error"] = (type(e).__name__, str(e))
    finally:
        dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _checks(rank, device, backend, lines, *, arch, batch, seq,
            model_parallel, method) -> bool:
    import numpy as np

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.engine import Engine
    from repro_torch.core.taps import PexSpec
    from repro_torch.dist import pex
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_leaves, tree_paths

    mesh = make_host_mesh(model_parallel, device_type=device.type)
    n_shards = mesh.size(0)
    aspec = registry.get(arch)
    cfg = aspec.smoke()
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    spec = PexSpec(enabled=True, method=method)
    loss_fn = registry.make_loss_fn_v2(aspec, cfg)
    data = registry.make_train_batch(
        aspec, cfg, ShapeSpec("selfcheck", "train", seq, batch),
        device=device)
    eng_local = Engine(spec)
    eng_mesh = Engine(spec, mesh=mesh)
    got = eng_mesh.value_grads_and_norms(loss_fn, params, data)
    pex.check_replicated(params, mesh, what="parameters")
    pex.check_replicated(got.grads, mesh, what="reduced gradients")
    got_n = eng_mesh.value_and_norms(loss_fn, params, data)
    clip = 0.5 * float(torch.sqrt(torch.median(got.sq_norms.sum(-1))))
    got_c = eng_mesh.clipped_step(loss_fn, params, data, clip_norm=clip)
    cons = [plan_mod.Clip(clip), plan_mod.GNS()]
    got_p = eng_mesh.step(loss_fn, params, data, consumers=cons)
    if rank:
        return True

    ok = True

    def check(name, a, b, rtol=1e-5, atol=1e-6):
        nonlocal ok
        a = np.asarray(a.detach().float().cpu())
        b = np.asarray(b.detach().float().cpu())
        good = np.allclose(a, b, rtol=rtol, atol=atol)
        ok &= good
        err = np.max(np.abs(a - b)) if a.size else 0.0
        lines.append(f"[{'ok' if good else 'FAIL'}] {name:24s} "
                     f"max|Δ|={err:.3g}")

    def check_tree(tag, ref_tree, got_tree):
        for path, a, b in zip(tree_paths(ref_tree), tree_leaves(ref_tree),
                              tree_leaves(got_tree)):
            check(tag + "".join(f"[{p!r}]" for p in path), a, b,
                  rtol=1e-4, atol=1e-5)

    ref = eng_local.value_grads_and_norms(loss_fn, params, data)
    check("loss", ref.loss, got.loss)
    check("loss_vec", ref.loss_vec, got.loss_vec)
    check("sq_norms", ref.sq_norms, got.sq_norms, rtol=1e-4)
    check_tree("grads", ref.grads, got.grads)
    ref_n = eng_local.value_and_norms(loss_fn, params, data)
    check("norms-only sq_norms", ref_n.sq_norms, got_n.sq_norms, rtol=1e-4)
    ref_c = eng_local.clipped_step(loss_fn, params, data, clip_norm=clip)
    check_tree("clipped", ref_c.grads, got_c.grads)
    ref_p = eng_local.step(loss_fn, params, data, consumers=cons)
    check("plan gns", ref_p.gns, got_p.gns, rtol=1e-4)
    check("plan weights", ref_p.weights, got_p.weights, rtol=1e-4)
    check_tree("plan", ref_p.grads, got_p.grads)

    gns = pex.gradient_noise_scale(got.sq_norms, got.grads)
    lines.append(f"{'PASS' if ok else 'FAIL'}: {n_shards}-way data-parallel "
                 f"(model_parallel={model_parallel}, {backend}, "
                 f"{device.type}) matches single-process; "
                 f"B_simple={float(gns):.3g}")
    return ok


def run(arch: str = "llama3.2-1b", batch: int = 8, seq: int = 8,
        model_parallel: int = 1, method: str = "gram",
        device: str = "cuda", world_size: int = 0,
        verbose: bool = True) -> int:
    """Spawn the ranks and report; 0 on PASS, 1 on a mismatch, 2 when the
    world has fewer than two ranks. A refusal on the ranks (a batch the
    shards do not divide, a model axis) is raised here."""
    import torch.multiprocessing as mp

    from repro_torch.nn.param import resolve_device

    dev = resolve_device(device)
    world = world_size or (torch.cuda.device_count() if dev.type == "cuda"
                           else 8)
    if world < 2:
        print(f"selfcheck needs >= 2 ranks (got {world}); pass "
              f"--world-size N")
        return 2
    kw = dict(arch=arch, batch=batch, seq=seq, model_parallel=model_parallel,
              method=method, device=dev.type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, f"file://{tmp}/store", tmp,
                                        kw),
                           nprocs=world, start_method="spawn")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]
    for o in outs:
        if o["error"] is not None:
            name, msg = o["error"]
            raise _RAISED[name](msg)
    report = outs[0]["lines"]
    for line in report if verbose else report[-1:]:
        print(line)
    return 0 if all(o["ok"] for o in outs) else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--method", default="gram")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--world-size", type=int, default=0,
                    help="ranks to spawn (default: 8 on the CPU, the card "
                         "count on CUDA)")
    sys.exit(run(**{k.replace("-", "_"): v
                    for k, v in vars(ap.parse_args()).items()}))


if __name__ == "__main__":
    main()
