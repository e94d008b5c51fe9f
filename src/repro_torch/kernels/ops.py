"""Public wrappers around the CUDA kernels — what ``core.norms`` and
``nn.attention`` call.

Port of the ``gram_norm`` / ``direct_norm`` / ``segmented_norm`` /
``rowsumsq`` / ``clip_scale`` wrappers and the flash attention ops
(``flash_attention_vjp``) of ``src/repro/kernels/ops.py``.
Each wrapper takes the plain PyTorch version for tensors on the CPU (the
tests' device) and launches its CUDA kernel for tensors on a CUDA device;
any other device raises. There is no fallback from the CUDA path to the
plain version: a kernel that fails to build or launch raises.

Each wrapper carries a plain integer launch counter (``gram_norm.launches``,
``direct_norm.launches``, ``segmented_norm.launches``,
``rowsumsq.launches``, ``clip_scale.launches``,
``flash_attention.launches``,
``flash_attention_bwd.dq_launches`` and ``.dkv_launches``) that it raises by
one where it launches its kernel, and nowhere else, so a run can show which
kernels its main path went through. An empty input to a norm wrapper (a
zero batch, sequence or feature extent) has the norm 0 and launches
nothing, so it is answered here and not counted; so are an empty
``rowsumsq`` (zeros) and an empty ``clip_scale`` (an empty tensor).

``gram_cost`` and ``direct_cost`` price the two dense kernels for
``core.norms.pick_method(use_kernels=True)``: device seconds per example on
the H100, from the work each bf16 body does at its own tiles, the rate it
reaches and the bytes it must read. The reference priced its Pallas
kernels in flops at padded TPU tiles; none of those constants is carried
over.

Not carried over: the TPU wrappers' 128-lane padding (``_launch_tiles``,
``_seg_launch_tiles``, and the zero-padding of ``rowsumsq`` and
``clip_scale`` to whole tiles), the segmented kernel's run tables
(``_run_tables``) and ``segmented_cost``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import clip_scale as _cs
from repro_torch.kernels import direct_norm as _dn
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram_norm as _gn
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rowsumsq as _rs
from repro_torch.kernels import segmented_norm as _sn


def _on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"{what}: the inputs must all lie on the CPU or on a "
                     f"CUDA device, got {[str(t.device) for t in tensors]}")


def _empty(h: torch.Tensor, zbar: torch.Tensor) -> bool:
    return h.numel() == 0 or zbar.numel() == 0


def _zeros(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((h.shape[0],), dtype=torch.float32, device=h.device)


def flop_estimate(b: int, s: int, p_in: int, p_out: int) -> float:
    """The fewer operations of the two forms of ||H_jᵀZ̄_j||²_F on a
    (b, s, p) problem: the least work the function takes, whichever route
    the dispatch picks. The gram form is counted as the bound counts it
    (``gram_norm.bound_flop_estimate``), not at the kernel's own tile."""
    return min(_gn.bound_flop_estimate(b, s, p_in, p_out),
               _dn.flop_estimate(b, s, p_in, p_out))


#: Rates of the bf16 bodies on an NVIDIA H100 80GB HBM3 at a 700 W power
#: limit, each over its own work (``gram_norm.flop_estimate`` at 128-row
#: tile pairs; ``direct_norm.flop_estimate`` at the body's ``TILE``), from
#: ``chip_smoke.norm_times()`` at llama3.2-1b's wk/wv launch (B=8, S=512,
#: 2048 → 512), the main path's closest call between the two: gram
#: 0.02672–0.02685 ms, direct 0.01950–0.01970 ms a launch. Each body's rate
#: grows with the launch (gram to ~540, direct to ~690 TFLOP/s at the LM
#: head), so these price large launches high, both by a like factor.
GRAM_FLOPS_PER_S = 250.7e12
DIRECT_FLOPS_PER_S = 439.2e12
#: HBM3 rate of the H100 SXM
HBM_BYTES_PER_S = 3.35e12


def _read_s(s: int, p_in: int, p_out: int) -> float:
    """Seconds to read one example's bf16 rows of h and z̄ once and write
    its f32 norm: the floor under either kernel."""
    return (2.0 * s * (p_in + p_out) + 4.0) / HBM_BYTES_PER_S


def gram_cost(s: int, p_in: int, p_out: int) -> float:
    """Device seconds per example of the gram kernel on a (·, s, p_in) ×
    (·, s, p_out) layer: its work over its rate, or its bytes over the HBM
    rate, whichever is longer."""
    return max(_gn.flop_estimate(1, s, p_in, p_out) / GRAM_FLOPS_PER_S,
               _read_s(s, p_in, p_out))


def direct_cost(s: int, p_in: int, p_out: int) -> float:
    """Device seconds per example of the direct kernel: its work with the
    feature axes padded to its bf16 tile, over its rate, or its bytes
    over the HBM rate, whichever is longer."""
    t_in, t_out = _dn.TILE[torch.bfloat16]
    work = _dn.flop_estimate(1, s, -(-p_in // t_in) * t_in,
                             -(-p_out // t_out) * t_out)
    return max(work / DIRECT_FLOPS_PER_S, _read_s(s, p_in, p_out))


def segmented_flop_estimate(seg_ids: torch.Tensor, n_seg: int, p_in: int,
                            p_out: int) -> float:
    """The fewest operations ||Σ_{t:seg=j} h_t z̄_tᵀ||²_F needs on this
    data: each segment of n kept rows is a (1, n, p) problem of
    :func:`flop_estimate`, and an empty one costs nothing. The segmented
    launcher sends each segment to the form this counts as the fewer
    (``segmented_norm.takes_gram``); the kernels' own count
    (``segmented_norm.flop_estimate``) is above it by the gram route's
    padding to 64-row tiles and 64-feature chunks."""
    sizes = _sn.segment_sizes(seg_ids, n_seg).tolist()
    return float(sum(flop_estimate(1, n, p_in, p_out) for n in sizes if n))


def gram_norm(h: torch.Tensor, zbar: torch.Tensor, *,
              triangular: bool = True) -> torch.Tensor:
    """(B,S,p_in),(B,S,p_out) → (B,) f32 Σ_{t,t'}<h_t,h_t'><z̄_t,z̄_t'>.

    ``triangular`` (default) visits only the upper triangle of sequence-
    tile pairs; ``False`` runs the full grid, kept for regression tests."""
    if _on_cpu("gram_norm", h, zbar):
        return _ref.gram_norm_ref(h, zbar)
    if _empty(h, zbar):
        return _zeros(h)
    out = _gn.gram_norm(h, zbar, triangular=triangular)
    gram_norm.launches += 1
    return out


gram_norm.launches = 0


def direct_norm(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """(B,S,p_in),(B,S,p_out) → (B,) f32 ||H_jᵀZ̄_j||²_F."""
    if _on_cpu("direct_norm", h, zbar):
        return _dn.direct_norm_ref(h, zbar)
    if _empty(h, zbar):
        return _zeros(h)
    out = _dn.direct_norm(h, zbar)
    direct_norm.launches += 1
    return out


direct_norm.launches = 0


def segmented_norm(h: torch.Tensor, zbar: torch.Tensor,
                   seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(T,p_in),(T,p_out),(T,) int → (n_seg,) f32 ||Σ_{t:seg=j} h_t z̄_tᵀ||².

    Rows whose id lies outside ``[0, n_seg)`` (capacity padding, dropped
    tokens) are discarded and an empty segment reads 0. ``n_seg <= 0``
    gives an empty vector and an empty input zeros, without a launch."""
    on_cpu = _on_cpu("segmented_norm", h, zbar, seg_ids)
    if n_seg < 1 or _empty(h, zbar):
        return torch.zeros((max(n_seg, 0),), dtype=torch.float32,
                           device=h.device)
    if on_cpu:
        return _sn.segmented_norm_ref(h, zbar, seg_ids, n_seg)
    out = _sn.segmented_norm(h, zbar, seg_ids, n_seg)
    segmented_norm.launches += 1
    return out


segmented_norm.launches = 0


def rowsumsq(x: torch.Tensor, keep: int = 1) -> torch.Tensor:
    """Σx² in f32 over every axis past the first ``keep``: the reference's
    (B, ...) → (B,) with ``keep=1``, the token layout's (B, S, ...) →
    (B, S) with ``keep=2``. The kept axes go to the kernel as (rows of
    rows) at their strides, so a strided (B, S, p) view is not copied;
    trailing axes that cannot be viewed as one are."""
    if not 1 <= keep <= x.ndim:
        raise ValueError(f"rowsumsq: keep={keep} must lie in [1, "
                         f"{x.ndim}] for a {x.ndim}-d input")
    lead = x.shape[:keep]
    n = math.prod(x.shape[keep:])
    rows = x.reshape(*lead, n)
    if _on_cpu("rowsumsq", x):
        return _ref.rowsumsq_ref(rows)
    if x.numel() == 0:
        return torch.zeros(lead, dtype=torch.float32, device=x.device)
    out = _rs.rowsumsq(rows.reshape(math.prod(lead[:-1]), lead[-1], n))
    rowsumsq.launches += 1
    return out.reshape(lead)


rowsumsq.launches = 0


def clip_scale(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, ...) ⊙ c (B,) → a new tensor of z's shape and dtype: each
    example's rows times its coefficient, multiplied in f32 and rounded
    once. The axes between the first and the last go to the kernel as one
    (a view where z's strides allow it)."""
    if z.ndim < 2 or c.shape != z.shape[:1]:
        raise ValueError(f"clip_scale: expected z (B, ..., N) and c (B,), "
                         f"got {tuple(z.shape)} and {tuple(c.shape)}")
    if _on_cpu("clip_scale", z, c):
        return _ref.clip_scale_ref(z, c)
    if z.numel() == 0:
        return torch.empty(z.shape, dtype=z.dtype, device=z.device)
    b, n = z.shape[0], z.shape[-1]
    out = _cs.clip_scale(z.reshape(b, math.prod(z.shape[1:-1]), n), c)
    clip_scale.launches += 1
    return out.reshape(z.shape)


clip_scale.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, softcap: Optional[float] = None,
                    window: Optional[int] = None, return_lse: bool = False):
    """Causal GQA attention. q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) → O like q
    [+ lse (B,Hq,Sq) f32 when ``return_lse``, for the backward]."""
    kw = dict(scale=scale, softcap=softcap, window=window)
    if _on_cpu("flash_attention", q, k, v):
        o, lse = _fa.flash_attention_fwd_ref(q, k, v, **kw)
    else:
        o, lse = _fa.flash_attention_fwd(q, k, v, **kw)
        flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None):
    """(dQ, dK, dV) of :func:`flash_attention` from its O and lse and the
    cotangent dO: the dQ kernel, then the dK/dV kernel."""
    kw = dict(scale=scale, softcap=softcap, window=window)
    if _on_cpu("flash_attention_bwd", q, k, v, o, lse, do):
        return _fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    delta = _fa.row_delta(o, do)
    dq = _fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    flash_attention_bwd.dq_launches += 1
    dk, dv = _fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    flash_attention_bwd.dkv_launches += 1
    return dq, dk, dv


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, O, lse)
    and the backward runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        o, lse = flash_attention(q, k, v, scale=scale, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.window = scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse, do, scale=ctx.scale,
                                    window=ctx.window)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def flash_attention_vjp(q, k, v, scale: float, window: Optional[int] = None):
    """Differentiable flash attention: kernel forward (online softmax, lse
    residual) and kernel backward (dQ, dK/dV). The S² score tensor never
    reaches device memory in either direction."""
    return _FlashAttention.apply(q, k, v, scale, window)


def reset_launch_counts() -> None:
    """Set every wrapper's launch counter to 0."""
    gram_norm.launches = 0
    direct_norm.launches = 0
    segmented_norm.launches = 0
    rowsumsq.launches = 0
    clip_scale.launches = 0
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {"gram_norm": gram_norm.launches,
            "direct_norm": direct_norm.launches,
            "segmented_norm": segmented_norm.launches,
            "rowsumsq": rowsumsq.launches,
            "clip_scale": clip_scale.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.dq_launches,
            "flash_attention_bwd_dkv": flash_attention_bwd.dkv_launches}
