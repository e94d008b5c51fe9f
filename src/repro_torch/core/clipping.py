"""Clipping — the coefficient math behind the ``Clip`` consumer, plus the
paper's §6 one-pass form.

Port of ``src/repro/core/clipping.py``. The ``Clip`` consumer of the plan
layer (``core.plan``) folds per-example coefficients ``min(1, C/‖g_j‖)``
(``core.passes.clip_coefficients``, re-exported here) — or per-token
coefficients from the (B, S) ``TokenLayout`` map
(:func:`token_clip_coefficients`) — into the seed of one reweighted
backward.

The rest of the file is paper §6's *one-pass* form: after the norms are
known, each example's Z̄ rows are rescaled and only the final backprop step
W̄⁽ⁱ⁾' = X⁽ⁱ⁾ᵀ Z̄⁽ⁱ⁾' is recomputed — no second backward pass. It needs
every (H, Z̄) pair at once, which the paper's MLP setting affords; the
plan's two-pass form gives the same result in O(batch) memory.

Mechanism: "perturbation taps". The model forward is written as

    forward(params, taps, batch) -> (loss_vec, hs)

where each dense layer computes ``z = h @ W + taps[name]`` with
``taps[name]`` a zeros tensor of z's shape, and ``hs[name]`` is the layer
input it returns. One ``torch.autograd.grad`` w.r.t. the taps yields every
layer's per-example Z̄ in one backward pass.

Kernels: the MLP-form norms are ``rowsumsq(z̄)·rowsumsq(h)``
(``kernels.ops.rowsumsq``), the sequence form takes ``stat_dense``'s
kernel route (gram or direct), and the Z̄ rescale is
``kernels.ops.clip_scale``. Each wrapper launches its CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors. The steps run on the
device the parameters live on.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import norms as N
from repro_torch.core.passes import clip_coefficients
from repro_torch.core.provenance import mark_clip
from repro_torch.dist.sharding import shard
from repro_torch.kernels import ops as kops
from repro_torch.nn.param import resolve_device, tree_leaves

__all__ = ["clip_coefficients", "token_clip_coefficients", "zero_taps",
           "norms_from_taps", "norms_from_taps_seq",
           "onepass_clipped_weight_grads", "onepass_clipped_weight_grads_seq"]


def token_clip_coefficients(sq_norms: torch.Tensor, clip_norm: float,
                            eps: float = 1e-6) -> torch.Tensor:
    """c_{j,t} = min(1, C / ‖g_{j,t}‖) elementwise on the (B, S)
    ``TokenLayout`` norm map — the per-token analogue of
    ``clip_coefficients`` (which sums group columns; the token map has
    none to sum)."""
    c = torch.clamp(
        clip_norm / (torch.sqrt(sq_norms.to(torch.float32)) + eps), max=1.0)
    return mark_clip(c, clip_norm=clip_norm, eps=eps, granularity="token")


def zero_taps(shapes: Dict[str, Tuple[int, ...]], dtype=torch.float32,
              device=None) -> Dict[str, torch.Tensor]:
    """Zero perturbation taps, one per layer name, on ``device`` (default
    CUDA). Each tap (and its cotangent Z̄) leads with the example axis,
    under the reference's ``shard(..., "batch", ...)`` constraint (the
    identity on these plain tensors)."""
    device = resolve_device(device)
    return {k: shard(torch.zeros(s, dtype=dtype, device=device), "batch",
                     *([None] * (len(s) - 1)))
            for k, s in shapes.items()}


def norms_from_taps(hs: Dict[str, torch.Tensor],
                    zbars: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Paper §4: s_j = Σ_i ‖z̄_j⁽ⁱ⁾‖²·‖h_j⁽ⁱ⁻¹⁾‖² (the rank-1 / MLP case).
    Extra shared axes are folded (exact only for the MLP form)."""
    total = None
    for name, zb in zbars.items():
        h = hs[name]
        s = kops.rowsumsq(zb, zb.ndim - 1) * kops.rowsumsq(h, h.ndim - 1)
        while s.ndim > 1:
            s = torch.sum(s, dim=-1)
        total = s if total is None else total + s
    return total


def norms_from_taps_seq(hs: Dict[str, torch.Tensor],
                        zbars: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Exact per-example norms from (H, Z̄) under sequence weight sharing:
    Σ_i ‖H_i^(j)ᵀ Z̄_i^(j)‖²_F, by ``stat_dense``'s cost-model pick and its
    kernel route."""
    total = None
    for name, zb in zbars.items():
        s = N.stat_dense(hs[name], zb, method="auto")
        total = s if total is None else total + s
    return total


def _taps_and_zbars(forward: Callable, params, batch,
                    tap_shapes: Dict[str, Tuple[int, ...]]):
    """One forward with zero taps on the parameters' device and one
    backward of Σ_j loss_vec w.r.t. the taps: (loss_vec, hs, zbars)."""
    device = tree_leaves(params)[0].device
    taps = {k: t.requires_grad_()
            for k, t in zero_taps(tap_shapes, device=device).items()}
    loss_vec, hs = forward(params, taps, batch)
    names = list(taps)
    zbars = torch.autograd.grad(torch.sum(loss_vec), [taps[k] for k in names])
    hs = {k: v.detach() for k, v in hs.items()}
    return loss_vec.detach(), hs, dict(zip(names, zbars))


def _clipped_weight_grads(hs, zbars, c):
    """W̄⁽ⁱ⁾' = Σ over rows of h_rowᵀ (c ⊙ z̄)_row for every layer, the
    rescale through ``kernels.ops.clip_scale``."""
    wbar = {}
    for name, zb in zbars.items():
        h = hs[name]
        zs = kops.clip_scale(zb, c)
        dt = torch.promote_types(h.dtype, zs.dtype)
        wbar[name] = (h.reshape(-1, h.shape[-1]).to(dt).t()
                      @ zs.reshape(-1, zs.shape[-1]).to(dt))
    return wbar


def onepass_clipped_weight_grads_seq(forward: Callable, params, batch,
                                     tap_shapes: Dict[str, Tuple[int, ...]],
                                     clip_norm: float):
    """§6 one-pass for sequence models: the flow of the MLP form, but the
    norms use the exact estimators of ``stat_dense`` and the final step is
    W̄⁽ⁱ⁾' = Σ_t X_tᵀ (c ⊙ Z̄_t). One backward pass; the re-run is only
    the dW products, at the cost of storing every (H, Z̄)."""
    loss_vec, hs, zbars = _taps_and_zbars(forward, params, batch,
                                          tap_shapes)
    sq_norms = norms_from_taps_seq(hs, zbars)
    c = clip_coefficients(sq_norms, clip_norm)
    return loss_vec, sq_norms, _clipped_weight_grads(hs, zbars, c)


def onepass_clipped_weight_grads(forward: Callable, params, batch,
                                 tap_shapes: Dict[str, Tuple[int, ...]],
                                 clip_norm: float):
    """Run the full §6 pipeline once.

    Returns (loss_vec, sq_norms, wbar_prime) where ``wbar_prime`` maps
    layer name -> clipped-sum weight gradient X⁽ⁱ⁾ᵀ (c ⊙ Z̄⁽ⁱ⁾)."""
    loss_vec, hs, zbars = _taps_and_zbars(forward, params, batch,
                                          tap_shapes)
    sq_norms = norms_from_taps(hs, zbars)
    c = clip_coefficients(sq_norms, clip_norm)
    return loss_vec, sq_norms, _clipped_weight_grads(hs, zbars, c)
