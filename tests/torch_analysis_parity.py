"""Shared by ``tests/test_torch_analysis.py``: what each spawned gloo rank
does for the collectives pass (this module imports no JAX, so the ranks
start quickly), and the port's flow mutants.

The mutants rebuild, in the port, the DP-pipeline bugs of
``tests/test_pexlint_mutation.py`` by monkeypatching the port's own seams
— ``core.plan.run_fused`` / ``add_grad_noise`` / ``_compose_weights`` and
``dist.pex._gather_rows``, module-level names that ``plan.execute`` and
``dist.pex.plan_step`` resolve at call time:

  * noise added per rank inside the region (before the all-reduce);
  * noise applied twice to the reduced gradient;
  * clip coefficients computed but never folded into the backward seed;
  * every leaf's noise drawn from one generator state;
  * a per-example output summed over the data shards.
"""
import contextlib
import dataclasses

import torch

from repro_torch import pex
from repro_torch.analysis import _trace
from repro_torch.analysis import collectives as col
from repro_torch.analysis import privacy as priv
from repro_torch.analysis.__main__ import lint_config
from repro_torch.core import passes
from repro_torch.core import plan as plan_mod
from repro_torch.dist import pex as dpex
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.nn.param import tree_leaves


def dp_consumers():
    """``tests/test_pexlint_mutation.py``'s DP_CONSUMERS in the port."""
    return [pex.Clip(1.0), pex.Noise(0.1, torch.Generator().manual_seed(0))]


def dp_trace(mesh=None, arch="llama3.2-1b"):
    """A recorded DP step of ``arch``'s smoke config at the lint shape
    (B=3, S=8; B=4 on a mesh, so that two ranks split it)."""
    _, _, loss_fn, params, batch = lint_config(
        arch, batch=3 if mesh is None else 4)
    return _trace.trace_step(loss_fn, params, batch, dp_consumers(),
                             mesh=mesh)


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def noise_before_psum():
    """Noise added on each rank inside the region; the plan's noise
    step made the identity."""
    real_fused = plan_mod.run_fused
    real_noise = plan_mod.add_grad_noise

    def in_region(sub, acc_loss, p, b, bs, layout, *, loss_weights=None):
        lv, aux, sq, grads, w, tw, cc = real_fused(
            sub, acc_loss, p, b, bs, layout, loss_weights=loss_weights)
        if sub.noise is not None and grads is not None:
            scale = sub.noise.scale if sub.noise.scale is not None \
                else sub.clip.clip_norm
            grads = real_noise(grads, sub.noise.noise_std, scale,
                               sub.noise.rng)
        return lv, aux, sq, grads, w, tw, cc

    stack = contextlib.ExitStack()
    stack.enter_context(patched(plan_mod, "run_fused", in_region))
    stack.enter_context(patched(plan_mod, "add_grad_noise",
                                lambda g, *a, **kw: g))
    return stack


def double_noise():
    """The noise step applied twice to the reduced gradient."""
    real_noise = plan_mod.add_grad_noise

    def twice(grads, noise_std, clip_norm, rng):
        once = real_noise(grads, noise_std, clip_norm, rng)
        return real_noise(once, noise_std, clip_norm, rng)

    return patched(plan_mod, "add_grad_noise", twice)


def unclipped_leaf():
    """Clip coefficients computed (and returned) but never folded into the
    backward seed."""
    real_compose = plan_mod._compose_weights

    def drop_fold(plan, sq_norms, loss_weights, extra_weights=None):
        _, tw, cc = real_compose(plan, sq_norms, loss_weights,
                                 extra_weights)
        unfolded = real_compose(
            dataclasses.replace(plan, clip=None), sq_norms, loss_weights,
            extra_weights)[0]
        return unfolded, tw, cc

    return patched(plan_mod, "_compose_weights", drop_fold)


def reused_key():
    """Every leaf's noise drawn from one generator state: one step seed,
    and ``tenant_generator(seed, 0)`` built anew for each leaf."""
    def shared_key(grads, noise_std, clip_norm, rng):
        seed = passes.step_seed(rng)
        for g in tree_leaves(grads):
            passes._noise_leaves([g], noise_std, clip_norm,
                                 passes.tenant_generator(seed, 0, g.device))
        return grads

    return patched(plan_mod, "add_grad_noise", shared_key)


def per_example_psum():
    """Each rank's per-example rows summed over the data shards (no
    zero-filled global buffer): the loss vector silently becomes the
    cross-shard sum."""
    def summed(x, shards):
        x = x.clone()
        dpex._all_reduce(x, shards, "gather")
        return x

    return patched(dpex, "_gather_rows", summed)


MESH_MUTANTS = {"noise_before_psum": noise_before_psum,
                "per_example_psum": per_example_psum}


def _codes(report) -> list:
    return sorted({f.code for f in report.findings})


def collectives_rank(rank, world):
    """On each gloo rank: the clean DP step and each mesh mutant recorded
    over a (world, 1) host mesh; the collectives and privacy codes of each,
    the clean step's schedule and its all-reduces by kind."""
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    for name, mutant in [("clean", contextlib.nullcontext)] \
            + sorted(MESH_MUTANTS.items()):
        with mutant():
            tr = dp_trace(mesh)
        c = col.analyze_trace(tr)
        p = priv.analyze_trace(tr)
        out[name] = {"collectives": _codes(c), "privacy": _codes(p)}
        if name == "clean":
            out["schedule"] = [dataclasses.astuple(e) for e in c.schedule]
            out["reduces"] = sorted((r.kind, r.declared, r.count, r.shape)
                                    for r in c.reduces)
            out["outputs"] = sorted((o.field, o.per_example, o.sums)
                                    for o in c.outputs if not o.leaf)
            out["grad_sums"] = sorted({o.sums for o in c.outputs
                                       if o.field == "grads"})
    return out
