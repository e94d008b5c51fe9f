"""Per-example transform helpers the plan layer builds on.

Port of the parts of ``src/repro/core/passes.py`` that ``core.plan`` uses:
the ``PexResult`` tuple, noise-argument checks, DP-SGD noise and the
per-example clip coefficients. The fixed-function passes of the reference
(``value_and_norms`` and friends) are sugar on ``Engine`` in the port.

Noise: the reference draws from JAX threefry keys, which PyTorch cannot
reproduce. The port draws from an explicit ``torch.Generator``; tests hold
it to the reference by handing both packages the same sample
(``_standard_normal`` is the one place a sample is drawn) and check the
port's own draws by their moments.

Per-tenant noise (``add_grad_noise_segmented``): the reference keys tenant
t's noise by ``fold_in(rng, t)``, and a ``torch.Generator`` cannot be
folded. So each step draws one seed from the caller's generator
(:func:`step_seed`; it changes every step) and tenant t draws from a
generator seeded with ``fold_seed(step seed, t)``
(:func:`tenant_generator`): its noise depends on the step and on its own
id, never on its batchmates. The ``core.provenance`` ``mark_*``
identity markers of the reference are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.provenance import (generator_device, mark_clip,
                                        mark_noise, mark_rng)
from repro_torch.dist.sharding import is_dtensor, like
from repro_torch.nn.param import fold_seed, tree_leaves


class PexResult(NamedTuple):
    loss: torch.Tensor         # scalar total C
    loss_vec: torch.Tensor     # (B,) per-example losses
    aux: object
    sq_norms: torch.Tensor     # (B, G) per-example ||grad||²
    grads: object = None       # param tree (when requested)


def check_noise_args(noise_std: float, noise_rng) -> None:
    """DP-SGD noise needs a generator; fail early with a clear error."""
    if noise_std and noise_std > 0.0 and noise_rng is None:
        raise ValueError(
            f"noise_std={noise_std} > 0 requires a generator: pass "
            f"rng=torch.Generator(device=...).manual_seed(...) (DP-SGD noise "
            f"is irreproducible without one)")


def _standard_normal(shape, generator: torch.Generator,
                     device) -> torch.Tensor:
    """One f32 N(0, 1) sample of ``shape`` from ``generator``."""
    return torch.randn(shape, generator=mark_rng(generator, purpose="noise"),
                       device=device, dtype=torch.float32)


def _noise_leaves(leaves, noise_std: float, clip_norm: float,
                  rng: torch.Generator, segment=None) -> None:
    """``g += (σ·C·sample).to(g.dtype)`` in place for each leaf, drawn in
    order from ``rng``; each scaled sample is marked ``noise`` (with
    ``segment``, the tenant of per-tenant noise). A DTensor leaf (the
    sharded route) draws the whole leaf's sample, as an unsharded step
    does, and adds the rank's shard of it: every rank draws the same
    numbers from its own copy of ``rng``, so the sharded step's noise is
    the unsharded step's."""
    for i, g in enumerate(leaves):
        local = g.to_local() if is_dtensor(g) else g
        sample = _standard_normal(g.shape, rng, local.device)
        if is_dtensor(g):
            sample = like(g, sample).to_local()
        local.add_(mark_noise(sample.mul_(noise_std * clip_norm)
                              .to(g.dtype), noise_std=noise_std,
                              scale=clip_norm, leaf=i, segment=segment))
        del sample          # before the next leaf's draw


def add_grad_noise(grads, noise_std: float, clip_norm: float,
                   rng: torch.Generator):
    """σ·C Gaussian noise per leaf — the DP-SGD noise step — added in
    place: the leaves of ``grads`` change and ``grads`` is returned, so no
    second gradient tree is formed (the temporaries are one leaf's f32
    sample, scaled in place, and its cast). Leaves are drawn in the tree's
    flattening order from one generator, which must live on the gradients'
    device. Each leaf gets the bits of ``g + (σ·C·sample).to(g.dtype)``."""
    check_noise_args(noise_std, rng)
    _noise_leaves(tree_leaves(grads), noise_std, clip_norm, rng)
    return grads


def step_seed(rng: torch.Generator) -> int:
    """One 62-bit seed drawn from ``rng`` (on its device; the host reads
    it back): the per-step root of the per-tenant generators."""
    return int(torch.randint(0, 2**62, (1,),
                             generator=mark_rng(rng, purpose="noise"),
                             device=rng.device))


def tenant_generator(seed: int, tenant: int, device) -> torch.Generator:
    """Tenant ``tenant``'s generator of the step whose seed is ``seed``, on
    ``device``: seeded with ``fold_seed(seed, tenant)``."""
    gen = torch.Generator(device=generator_device(device)).manual_seed(
        fold_seed(seed, tenant))
    return mark_rng(gen, purpose="noise", index=tenant, seed=seed)


def add_grad_noise_segmented(grads, noise_std: float, clip_norm: float,
                             rng: torch.Generator, segments):
    """Per-segment σ·C noise for trees whose leaves are stacked on a leading
    segment axis (the multi-tenant adapter tree: leaf shape (n_active,
    ...), row s owned by tenant ``segments[s]``), added in place as
    :func:`add_grad_noise` adds it.

    One seed is drawn from ``rng`` (:func:`step_seed`); tenant t's rows are
    the bits of ``add_grad_noise`` on t's tree alone with
    ``tenant_generator(seed, t)``. Samples are drawn at the one draw site,
    tenants in ``segments`` order, then leaves in flattening order."""
    check_noise_args(noise_std, rng)
    tenants = torch.as_tensor(segments).reshape(-1).tolist()
    leaves = tree_leaves(grads)
    if not leaves:
        return grads
    for i, g in enumerate(leaves):
        if g.shape[0] != len(tenants):
            raise ValueError(
                f"segmented noise leaf {i} has shape {tuple(g.shape)}; its "
                f"leading axis must match the {len(tenants)} segments (one "
                f"row per segment)")
    seed = step_seed(rng)
    for s, t in enumerate(tenants):
        _noise_leaves([g[s] for g in leaves], noise_std, clip_norm,
                      tenant_generator(seed, t, leaves[0].device), segment=s)
    return grads


def clip_coefficients(sq_norms: torch.Tensor, clip_norm: float,
                      eps: float = 1e-6) -> torch.Tensor:
    """c_j = min(1, C / ||g_j||). sq_norms: (B,) or (B,G) (summed)."""
    if sq_norms.ndim == 2:
        sq_norms = torch.sum(sq_norms, dim=-1)
    c = torch.clamp(clip_norm / (torch.sqrt(sq_norms) + eps), max=1.0)
    return mark_clip(c, clip_norm=clip_norm, eps=eps, granularity="example")
