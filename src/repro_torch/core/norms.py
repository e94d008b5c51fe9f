"""Per-example squared-gradient-norm estimators.

Port of ``src/repro/core/norms.py``. All estimators consume the pair the
paper identifies — the layer input ``H`` and the pre-activation cotangent
``Z̄`` — and return the exact per-example squared Frobenius norm of that
layer's parameter gradient, ``s_j = ||∂L^(j)/∂W||_F²``, as a ``(batch,)``
float32 vector.

Inputs are unshared ``(B, p)`` (the paper's MLP setting) or sequence-shared
``(B, S, p)`` (one weight application per position).

Methods: ``factorized`` (paper §4, exact only for (B, p)), ``gram``
(Σ_{t,t'} (H_jH_jᵀ)_{tt'} (Z̄_jZ̄_jᵀ)_{tt'}), ``direct`` (||H_jᵀZ̄_j||_F²)
and ``auto``, the cost-model pick between gram and direct.

Cost model (``dense_cost``), one price list per route, as in the
reference:

* ``use_kernels=False``: the **logical** flop model (gram
  2·S²·(p_in+p_out) + S², direct 2·S·p_in·p_out + 2·p_in·p_out), the
  reference's ``use_pallas=False`` side;
* ``use_kernels=True``: the Hopper kernels' device time per example
  (``kernels.ops.gram_cost`` / ``direct_cost``: the work each body does at
  its own tiles over the rate it reaches on the H100, or its bytes over
  the HBM rate). The reference priced its Pallas kernels at padded TPU
  tiles; the port derives its prices from its own kernels.

``stat_dense(method="auto")`` picks with the price list of the route it
runs.

The segmented estimator (``stat_direct_segmented``, the MoE expert taps'
stat) has two routes: ``method="xla"``, the reference's scan/segment-sum
formulation kept as the oracle, and ``method="kernel"`` through
``kernels.ops.segmented_norm`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors). The expert taps take the kernel route
whenever ``use_kernels`` is set, as the dense taps do. The reference's
two-sided segmented cost model is not carried over: it weighted the XLA
side by a TPU VPU factor (``XLA_SEGMENTED_VPU_WEIGHT``) and priced the
kernel at padded TPU tiles, and neither describes the H100.
``segmented_flops``, ``segmented_cost``, ``pick_segmented`` and
``crossover_t`` wait for a Hopper-priced model.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.direct_norm import direct_norm_ref
from repro_torch.kernels.ref import gram_norm_ref
from repro_torch.kernels.segmented_norm import drop_bucket

Method = Literal["factorized", "gram", "direct", "auto"]

_ACC_DTYPE = torch.float32


def rowsumsq(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over all but the leading (batch) axis. Returns (B,) f32."""
    x = x.to(_ACC_DTYPE)
    return torch.sum(torch.square(x), dim=tuple(range(1, x.ndim)))


def stat_factorized(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """Paper §4: s_j = ||z̄_j||² ||h_j||². Exact for (B, p) inputs; an
    upper bound (not exact) over flattened (S·p) rows of (B, S, p)."""
    return rowsumsq(zbar) * rowsumsq(h)


def stat_gram(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """Gram-pair estimator. h: (B,S,pi), zbar: (B,S,po) → (B,) f32.
    Materializes the (B,S,S) Grams; the CUDA kernel never does."""
    if h.ndim == 2:  # unshared: Gram is 1×1 → factorized, exactly the paper
        return stat_factorized(h, zbar)
    return gram_norm_ref(h, zbar)


def stat_direct(h: torch.Tensor, zbar: torch.Tensor,
                chunk: int = 1024) -> torch.Tensor:
    """||H_jᵀ Z̄_j||_F² without materializing (B, p_in, p_out) at once
    (chunked over p_in)."""
    if h.ndim == 2:
        return stat_factorized(h, zbar)
    return direct_norm_ref(h, zbar, chunk)


def gram_flops(s: int, p_in: int, p_out: int) -> float:
    """Gram-pair cost: two S×S Grams + their product-reduce."""
    return 2.0 * s * s * (p_in + p_out) + s * s


def direct_flops(s: int, p_in: int, p_out: int) -> float:
    """Direct cost: the HᵀZ̄ contraction + square-reduce."""
    return 2.0 * s * p_in * p_out + 2.0 * p_in * p_out


def dense_cost(method: str, s: int, p_in: int, p_out: int, *,
               use_kernels: bool = False) -> float:
    """Per-example cost of one dense-layer stat on one route: logical flops
    without ``use_kernels``, the kernel's device seconds on the H100 with
    it (``kernels.ops.gram_cost`` / ``direct_cost``)."""
    if method == "gram":
        return kops.gram_cost(s, p_in, p_out) if use_kernels \
            else gram_flops(s, p_in, p_out)
    if method == "direct":
        return kops.direct_cost(s, p_in, p_out) if use_kernels \
            else direct_flops(s, p_in, p_out)
    raise ValueError(f"unknown method {method!r}")


def pick_method(s: int, p_in: int, p_out: int,
                use_kernels: bool = False) -> str:
    """Cost-model choice between gram and direct (both exact) for the
    route that will run the stat."""
    g = dense_cost("gram", s, p_in, p_out, use_kernels=use_kernels)
    d = dense_cost("direct", s, p_in, p_out, use_kernels=use_kernels)
    return "gram" if g <= d else "direct"


def crossover_s(p_in: int, p_out: int, *, use_kernels: bool = False,
                s_max: int = 1 << 16) -> int:
    """Smallest sequence length at which ``direct`` beats ``gram`` under
    the route's cost model (binary search; gram grows ~s² and direct ~s),
    or ``s_max`` when gram wins there."""
    if pick_method(s_max, p_in, p_out, use_kernels) == "gram":
        return s_max
    lo, hi = 1, s_max
    while lo < hi:
        mid = (lo + hi) // 2
        if pick_method(mid, p_in, p_out, use_kernels) == "direct":
            hi = mid
        else:
            lo = mid + 1
    return lo


def stat_dense(h: torch.Tensor, zbar: torch.Tensor, method: Method = "auto",
               use_kernels: bool = True) -> torch.Tensor:
    """Dispatch a dense-layer stat. h (B,[S,]p_in), zbar (B,[S,]p_out).

    With ``use_kernels`` the gram and direct routes go through
    ``kernels.ops`` (the CUDA kernels for CUDA tensors, their plain
    versions for CPU tensors) and ``method="auto"`` picks by the kernels'
    prices; without it they run the plain estimators above on any device,
    picked by the logical flop model."""
    if h.ndim == 2:
        return stat_factorized(h, zbar)
    if method == "auto":
        method = pick_method(h.shape[1], h.shape[2], zbar.shape[-1],
                             use_kernels)
    if method == "factorized":
        return stat_factorized(h, zbar)
    if method == "gram":
        return kops.gram_norm(h, zbar) if use_kernels else stat_gram(h, zbar)
    if method == "direct":
        return kops.direct_norm(h, zbar) if use_kernels \
            else stat_direct(h, zbar)
    raise ValueError(f"unknown method {method!r}")


def stat_direct_segmented(h: torch.Tensor, zbar: torch.Tensor,
                          seg_ids: torch.Tensor, n_examples: int,
                          chunk_in: int = 128, token_block: int = 1024,
                          method: str = "kernel") -> torch.Tensor:
    """Exact per-segment norms for token-major layers (MoE expert buffers).

    h: (T, p_in), zbar: (T, p_out), seg_ids: (T,) segment (example) id
    per row. Rows with an id outside [0, n_examples) — capacity padding,
    dropped tokens — are discarded. Computes
    s_j = ||Σ_{t: seg=j} h_t z̄_tᵀ||², FLOPs ≈ 2·T·p_in·p_out.

    ``method``: ``"kernel"`` goes through ``kernels.ops.segmented_norm``;
    ``"xla"`` is the reference's scan/segment-sum form below (the
    oracle). ``n_examples < 1`` gives an empty vector and ``T == 0``
    zeros."""
    t, p_in = h.shape
    p_out = zbar.shape[-1]
    if n_examples < 1:
        return torch.zeros((max(n_examples, 0),), dtype=_ACC_DTYPE,
                           device=h.device)
    if t == 0:
        return torch.zeros((n_examples,), dtype=_ACC_DTYPE, device=h.device)
    if method == "kernel":
        return kops.segmented_norm(h, zbar, seg_ids, n_examples)
    if method != "xla":
        raise ValueError(f"unknown segmented method {method!r}")
    # explicit drop bucket: every invalid row lands in segment n_examples
    seg = drop_bucket(seg_ids, n_examples)
    h = h.to(_ACC_DTYPE)
    zbar = zbar.to(_ACC_DTYPE)
    out = torch.zeros((n_examples,), dtype=_ACC_DTYPE, device=h.device)
    for c0 in range(0, p_in, chunk_in):
        g = torch.zeros((n_examples + 1, min(chunk_in, p_in - c0), p_out),
                        dtype=_ACC_DTYPE, device=h.device)
        for t0 in range(0, t, token_block):
            h_b = h[t0:t0 + token_block, c0:c0 + chunk_in]
            z_b = zbar[t0:t0 + token_block]
            g.index_add_(0, seg[t0:t0 + token_block],
                         h_b[:, :, None] * z_b[:, None, :])
        out = out + torch.sum(torch.square(g[:n_examples]), dim=(1, 2))
    return out


def stat_bias(zbar: torch.Tensor) -> torch.Tensor:
    """Per-example ||∂L/∂b||²: b's gradient is Σ_t z̄_t."""
    if zbar.ndim == 2:
        return rowsumsq(zbar)
    v = torch.sum(zbar.to(_ACC_DTYPE), dim=tuple(range(1, zbar.ndim - 1)))
    return torch.sum(torch.square(v), dim=-1)


def stat_elementwise(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """Per-example norm for an elementwise parameter z = g ⊙ h:
    grad_g L^(j) = Σ_t z̄_{jt} ⊙ h_{jt}; exact, O(S·p)."""
    prod = zbar.to(_ACC_DTYPE) * h.to(_ACC_DTYPE)
    if prod.ndim > 2:
        prod = torch.sum(prod, dim=tuple(range(1, prod.ndim - 1)))
    return torch.sum(torch.square(prod), dim=-1)


def add_rows(out: torch.Tensor, index: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += rows[i]`` for every i, in place, adding the rows
    of one index in the same order on every run: on CUDA by ``index_put_``
    with ``accumulate`` (it sorts the indices; ``index_add_`` adds by
    atomics, whose order changes from run to run once three rows share an
    index), on the CPU by ``index_add_`` (serial; there ``index_put_`` is
    the one that is not)."""
    if out.is_cuda:
        return out.index_put_((index,), rows, accumulate=True)
    return out.index_add_(0, index, rows)


def stat_embedding(token_ids: torch.Tensor,
                   zbar: torch.Tensor) -> torch.Tensor:
    """Per-example norm for an embedding table E, z_t = E[x_t]:
    s_j = Σ_v ||Σ_{t: x_t=v} z̄_t||², by sort + segment sum, O(S·d + S log S).

    token_ids: (B, S) int, zbar: (B, S, d)."""
    zbar = zbar.to(_ACC_DTYPE)
    b, s, d = zbar.shape
    ids_s, order = torch.sort(token_ids, dim=-1)
    z_s = torch.gather(zbar, 1, order[..., None].expand(b, s, d))
    # segment id = rank of each distinct token value within its example
    new_seg = torch.ones_like(ids_s)
    new_seg[:, 1:] = (ids_s[:, 1:] != ids_s[:, :-1]).to(ids_s.dtype)
    seg = torch.cumsum(new_seg, dim=-1) - 1
    flat = seg + s * torch.arange(b, device=seg.device)[:, None]
    summed = add_rows(torch.zeros((b * s, d), dtype=zbar.dtype,
                                  device=zbar.device),
                      flat.reshape(-1), z_s.reshape(b * s, d))
    return torch.sum(torch.square(summed.reshape(b, s, d)), dim=(1, 2))
