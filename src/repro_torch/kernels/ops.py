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

Inside an analysis trace (``analysis._trace``) the tensors are ``meta``
tensors: each wrapper takes them as the card's route and, where it would
launch, records the launch (``core.provenance.kernel_site``) and returns
outputs of the kernel's shapes instead. Outside a trace a ``meta`` tensor
is refused like any device that is not the CPU or CUDA, so the recording
is never reached on the main path, and nothing is counted for it.

Not carried over: the TPU wrappers' 128-lane padding (``_launch_tiles``,
``_seg_launch_tiles``, and the zero-padding of ``rowsumsq`` and
``clip_scale`` to whole tiles), the segmented kernel's run tables
(``_run_tables``) and ``segmented_cost``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import provenance as _prov
from repro_torch.kernels import clip_scale as _cs
from repro_torch.kernels import contract as _c
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
    if devices == {"cuda"} or (devices == {"meta"} and _prov.tracing()):
        return False
    raise ValueError(f"{what}: the inputs must all lie on the CPU or on a "
                     f"CUDA device, got {[str(t.device) for t in tensors]}")


def _empty(h: torch.Tensor, zbar: torch.Tensor) -> bool:
    return h.numel() == 0 or zbar.numel() == 0


def _zeros(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((h.shape[0],), dtype=torch.float32, device=h.device)


def _norms_out(h: torch.Tensor) -> torch.Tensor:
    """A trace's stand-in for a norm kernel's (B,) output: allocated, not
    written (the launch's bytes are its contract's)."""
    return torch.empty((h.shape[0],), dtype=torch.float32, device=h.device)


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
    if h.is_meta:
        return _prov.kernel_site("gram_norm", (h, zbar), _norms_out(h),
                                 triangular=triangular)
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
    if h.is_meta:
        return _prov.kernel_site("direct_norm", (h, zbar), _norms_out(h))
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
    if h.is_meta:
        return _prov.kernel_site(
            "segmented_norm", (h, zbar, seg_ids),
            torch.empty((n_seg,), dtype=torch.float32, device=h.device),
            n_seg=n_seg)
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
    rows = rows.reshape(math.prod(lead[:-1]), lead[-1], n)
    if x.is_meta:
        return _prov.kernel_site(
            "rowsumsq", (rows,),
            torch.empty(lead, dtype=torch.float32, device=x.device))
    out = _rs.rowsumsq(rows)
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
    z3 = z.reshape(b, math.prod(z.shape[1:-1]), n)
    if z.is_meta:
        return _prov.kernel_site("clip_scale", (z3, c), torch.empty_like(z))
    out = _cs.clip_scale(z3, c)
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
    elif q.is_meta:
        o, lse = _prov.kernel_site(
            "flash_attention", (q, k, v),
            (torch.empty_like(q), torch.empty(q.shape[:3], dtype=torch.float32,
                                              device=q.device)), **kw)
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
    if q.is_meta:
        dq = _prov.kernel_site("flash_attention_bwd_dq",
                               (q, k, v, do, lse, delta),
                               torch.empty_like(q), **kw)
        dk, dv = _prov.kernel_site(
            "flash_attention_bwd_dkv", (q, k, v, do, lse, delta),
            (torch.empty_like(k), torch.empty_like(v)), **kw)
        return dq, dk, dv
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


# ---------------------------------------------------------------------------
# launch contracts (``kernels.contract``): the launch each wrapper issues
# ---------------------------------------------------------------------------
# The figures below mirror csrc/*.cu; ``chip_smoke.py`` holds each bf16
# body's contract against the built kernel's ``kernel_info()`` on the card.

#: smem_base()'s alignment slack, and one mbarrier (csrc/hopper.cuh)
_SMEM_SLACK = 1024
_BARRIER = 8
#: threads of the gram and direct bf16 bodies: two consumer warpgroups and
#: the producer warp (``kThreadsB``); of every other block (``kThreads``)
_WIDE_THREADS = 256 + 32
_THREADS = 256
#: the bf16 gram body's ring of tile chunks (``kStages``) and its launch
#: bounds' resident blocks
GRAM_STAGES = 3
GRAM_BLOCKS_PER_SM = 2
#: the f32 gram body's rows of a tile (``kTile``)
GRAM_F32_TILE = 64
#: the bf16 direct body's stages (``kStages``) of 64 sequence rows
#: (``kRowsB``)
DIRECT_STAGES = 4
DIRECT_ROWS = 64
#: the bf16 segmented gram body's ring, in 64 × 64 tile chunks (``kSlots``)
SEG_SLOTS = 6
#: rowsumsq: from this row width on a block owns a row (``kWideRow``),
#: below it a warp does (8 a block)
ROWSUMSQ_WIDE_ROW = _rs.WIDE_ROW
#: clip_scale's rows of the grid's y axis at most (``kMaxRowBlocks``)
CLIP_SCALE_MAX_ROW_BLOCKS = 65535
#: flash: q rows of a forward / dQ block (``kRows``), the rings' stages
#: (``kFwdStages``, ``kDqStages``, ``kDkvStages``), the f32 bodies' staged
#: tile (``kF32Tile``)
FLASH_ROWS = 128
FLASH_FWD_STAGES = 3
FLASH_DQ_STAGES = 4
FLASH_DKV_STAGES = 3
FLASH_F32_TILE = 32


def _strides(shape, strides):
    """``strides`` or the contiguous strides of ``shape``."""
    if strides is not None:
        return tuple(strides)
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _tma_maps(names, shapes, strides, offsets, isz, boxes):
    """The tensor maps of a bf16 launch whose operands take the TMA route
    (``_build.copy_route``: every base and stride but the last a multiple
    of 16 bytes), else () — the synchronous route encodes none. Each map's
    dimensions run from the contiguous axis out; ``boxes`` gives each
    map's box."""
    st = [_strides(sh, s) for sh, s in zip(shapes, strides)]
    offs = offsets if offsets is not None else (0,) * len(shapes)
    aligned = all(o * isz % 16 == 0 and all(x * isz % 16 == 0
                                            for x in s[:-1])
                  for o, s in zip(offs, st))
    if not aligned:
        return ()
    return tuple(_c.TmaDesc(n, o * isz,
                            tuple(x * isz for x in reversed(s[:-1])), box,
                            isz)
                 for n, o, s, box in zip(names, offs, st, boxes))


def norm_bytes(b: int, s: int, p_in: int, p_out: int, dtype) -> float:
    """Bytes a gram or direct launch must move: each example's rows of h
    and z̄ read once and its f32 norm written once (``_read_s``'s count)."""
    return float(b) * (s * (p_in + p_out) * _c.itemsize(dtype) + 4)


def gram_smem_bytes() -> int:
    """The bf16 gram body's dynamic shared memory: the ring of GRAM_STAGES
    stages of a 128 × 64 chunk of each tile of a pair, and a full and an
    empty barrier per stage (``gram_smem_bytes`` in csrc/gram_norm.cu)."""
    return (_SMEM_SLACK + GRAM_STAGES * 2 * _gn.TILE_S * _gn.CHUNK * 2
            + 2 * GRAM_STAGES * _BARRIER)


def gram_contract(b: int, s: int, p_in: int, p_out: int, *,
                  dtype=torch.bfloat16, triangular: bool = True,
                  strides=None, offsets=None, sms: int = _gn.SMS):
    """The partial-Gram launch of ``gram_norm`` on (b, s, p_in) ×
    (b, s, p_out): in bf16 one block per work row of the launcher's plan
    (``gram_norm.plan``: 128-row tile pairs, each tensor's chunks cut into
    its feature ranges), in f32 one block per (64-row tile pair,
    example)."""
    if _c.dtype_name(dtype) == "bfloat16":
        p = _gn.plan(b, s, p_in, p_out, triangular, sms)
        ring = _c.Buffer("ring", (GRAM_STAGES, 2, _gn.TILE_S, _gn.CHUNK),
                         torch.bfloat16)
        acc = _c.Buffer("gram_tile", (_gn.TILE_S, _gn.TILE_S), torch.float32,
                        where="regs", accumulator=True)
        tma = _tma_maps(("h", "zbar"), ((b, s, p_in), (b, s, p_out)),
                        strides or (None, None), offsets, 2,
                        ((_gn.CHUNK, _gn.TILE_S, 1),) * 2)
        return _c.LaunchContract(
            "gram_norm", (len(p.work),), _WIDE_THREADS, gram_smem_bytes(),
            GRAM_BLOCKS_PER_SM, buffers=(ring, acc), tma=tma,
            wgmma=(_c.Wgmma(64, _gn.TILE_S, 16, torch.bfloat16),),
            flops=flop_estimate(b, s, p_in, p_out),
            bytes=norm_bytes(b, s, p_in, p_out, dtype))
    n = -(-s // GRAM_F32_TILE)
    pairs = n * (n + 1) // 2 if triangular else n * n
    return _c.LaunchContract(
        "gram_norm", (pairs, b), _THREADS,
        buffers=(_c.Buffer("gram_tile", (GRAM_F32_TILE, GRAM_F32_TILE),
                           torch.float32, where="regs", accumulator=True),),
        flops=flop_estimate(b, s, p_in, p_out),
        bytes=norm_bytes(b, s, p_in, p_out, dtype))


def direct_smem_bytes() -> int:
    """The bf16 direct body's dynamic shared memory: DIRECT_STAGES stages of
    64 rows of a 128-wide h tile and a 256-wide z̄ tile, and a full and an
    empty barrier per stage (``direct_smem_bytes``)."""
    t_in, t_out = _dn.TILE[torch.bfloat16]
    return (_SMEM_SLACK + DIRECT_STAGES * DIRECT_ROWS * (t_in + t_out) * 2
            + 2 * DIRECT_STAGES * _BARRIER)


def direct_contract(b: int, s: int, p_in: int, p_out: int, *,
                    dtype=torch.bfloat16, strides=None, offsets=None):
    """The partial launch of ``direct_norm``: one block per (p_in tile,
    p_out tile, example) of ``direct_norm.tiles`` — 128 × 256 tiles of G in
    bf16, 128 × 128 in f32."""
    n_in, n_out = _dn.tiles(p_in, p_out, dtype)
    t_in, t_out = _dn.TILE[dtype]
    acc = _c.Buffer("g_tile", (t_in, t_out), torch.float32, where="regs",
                    accumulator=True)
    if _c.dtype_name(dtype) == "bfloat16":
        ring = _c.Buffer("ring", (DIRECT_STAGES, DIRECT_ROWS, t_in + t_out),
                         torch.bfloat16)
        tma = _tma_maps(("h", "zbar"), ((b, s, p_in), (b, s, p_out)),
                        strides or (None, None), offsets, 2,
                        ((64, DIRECT_ROWS, 1),) * 2)
        return _c.LaunchContract(
            "direct_norm", (n_in, n_out, b), _WIDE_THREADS,
            direct_smem_bytes(), 1, buffers=(ring, acc), tma=tma,
            wgmma=(_c.Wgmma(64, t_out, 16, torch.bfloat16),),
            flops=flop_estimate(b, s, p_in, p_out),
            bytes=norm_bytes(b, s, p_in, p_out, dtype))
    return _c.LaunchContract("direct_norm", (n_out, n_in, b), _THREADS,
                             buffers=(acc,),
                             flops=flop_estimate(b, s, p_in, p_out),
                             bytes=norm_bytes(b, s, p_in, p_out, dtype))


def segmented_smem_bytes() -> int:
    """The bf16 segmented gram body's dynamic shared memory: SEG_SLOTS
    64 × 64 tile chunks (``gram_smem_bytes`` in csrc/segmented_norm.cu)."""
    return _SMEM_SLACK + SEG_SLOTS * _sn.TILE_ROWS * _sn.CHUNK * 2


def segmented_work(t: int, n_seg: int, p_in: int, p_out: int, dtype,
                   seg_ids=None, id_itemsize: int = 4):
    """(flops, bytes) of one ``segmented_norm`` call, as the bound counts
    them: with the call's own ``seg_ids`` (a tensor holding values), the
    fewest operations this data needs (``segmented_flop_estimate``) and the
    kept rows read once (``segmented_norm.bytes_estimate``); without them
    (a trace, whose ids are ``meta``), every row kept and the rows spread
    evenly over the segments, which puts the gram form's work at its
    least."""
    isz = _c.itemsize(dtype)
    if seg_ids is not None and not seg_ids.is_meta:
        return (segmented_flop_estimate(seg_ids, n_seg, p_in, p_out),
                _sn.bytes_estimate(seg_ids, n_seg, p_in, p_out, isz))
    per, extra = divmod(t, max(n_seg, 1))
    flops = (extra * flop_estimate(1, per + 1, p_in, p_out)
             + (n_seg - extra) * flop_estimate(1, per, p_in, p_out)
             if per or extra else 0.0)
    return (float(flops), float(t * (p_in + p_out) * isz
                                + t * id_itemsize + 4 * n_seg))


def segmented_contract(t: int, n_seg: int, p_in: int, p_out: int, *,
                       dtype=torch.bfloat16, sms: int = _gn.SMS,
                       seg_ids=None, id_itemsize: int = 4) -> list:
    """The launches of ``segmented_norm`` on T = ``t`` rows and ``n_seg``
    segments, from the launcher's static bounds (``segmented_norm.limits``,
    the plan's list lengths): the gram route's persistent grid (at most
    BLOCKS_PER_SM blocks per SM) where a segment can take it, and the
    direct route's (128-wide tiles of G × ``direct_depth``) where one can
    take that. The call's work and bytes (:func:`segmented_work`) ride on
    the first."""
    lim = _sn.limits(t, n_seg, p_in, p_out)
    out = []
    bf16 = _c.dtype_name(dtype) == "bfloat16"
    if lim.items:
        blocks = min(lim.items, _sn.BLOCKS_PER_SM * sms)
        if bf16:
            out.append(_c.LaunchContract(
                "segmented_norm", (blocks,), 128, segmented_smem_bytes(),
                _sn.BLOCKS_PER_SM,
                buffers=(
                    _c.Buffer("ring", (SEG_SLOTS, _sn.TILE_ROWS, _sn.CHUNK),
                              torch.bfloat16),
                    _c.Buffer("grams", (2, _sn.TILE_ROWS, _sn.TILE_ROWS),
                              torch.float32, where="regs",
                              accumulator=True)),
                wgmma=(_c.Wgmma(64, _sn.TILE_ROWS, 16, torch.bfloat16),)))
        else:
            out.append(_c.LaunchContract("segmented_norm", (blocks,),
                                         _THREADS))
    if lim.directs:
        tiles_in = -(-p_in // _sn.DIRECT_TILE)
        tiles_out = -(-p_out // _sn.DIRECT_TILE)
        depth = _sn.direct_depth(lim.directs, tiles_in * tiles_out, sms)
        out.append(_c.LaunchContract(
            "segmented_norm_direct", (tiles_out, tiles_in, depth), _THREADS,
            buffers=(_c.Buffer("g_tile", (_sn.DIRECT_TILE, _sn.DIRECT_TILE),
                               torch.float32, where="regs",
                               accumulator=True),)))
    if out:
        flops, nbytes = segmented_work(t, n_seg, p_in, p_out, dtype,
                                       seg_ids, id_itemsize)
        out[0] = dataclasses.replace(out[0], flops=flops, bytes=nbytes)
    return out


def rowsumsq_contract(b: int, s: int, n: int, *, dtype=torch.bfloat16):
    """The ``rowsumsq`` launch on (b, s, n): a block per row from
    ROWSUMSQ_WIDE_ROW on, else a warp per row, 8 rows a block; the sum in
    f32."""
    rows = b * s
    grid = rows if n >= ROWSUMSQ_WIDE_ROW else -(-rows // (_THREADS // 32))
    return _c.LaunchContract(
        "rowsumsq", (grid,), _THREADS,
        buffers=(_c.Buffer("sum", (1,), torch.float32, where="regs",
                           accumulator=True),),
        flops=_rs.flop_estimate(rows, n),
        bytes=_rs.bytes_estimate(rows, n, _c.itemsize(dtype)))


def clip_scale_contract(b: int, s: int, n: int, *, dtype=torch.bfloat16):
    """The ``clip_scale`` launch on (b, s, n): 256 slots of a row a block
    on the x axis (16-byte vectors where the rows allow), rows on the y
    axis, at most CLIP_SCALE_MAX_ROW_BLOCKS of them (blocks stride the
    rest)."""
    vec = 16 // _c.itemsize(dtype)
    slots = n // vec if n % vec == 0 else n
    return _c.LaunchContract(
        "clip_scale", (-(-slots // _THREADS),
                       min(b * s, CLIP_SCALE_MAX_ROW_BLOCKS)), _THREADS,
        flops=_cs.flop_estimate(b * s * n),
        bytes=_cs.bytes_estimate(b * s * n, b, _c.itemsize(dtype)))


def flash_smem_bytes(kind: str, d: int, bf16: bool = True) -> int:
    """Dynamic shared memory of the flash body ``kind`` ("fwd", "dq",
    "dkv") at head dim ``d`` (``smem_bytes`` in
    csrc/flash_attention.cu)."""
    key = _fa.KEY_TILE
    if not bf16:
        tile = FLASH_F32_TILE * d * 4
        return 2 * tile + (2 * FLASH_F32_TILE * 4 if kind == "dkv" else 0)
    cm = key * d * 2
    if kind == "fwd":   # Q (128 rows), the stages of K and V, a barrier each
        return (_SMEM_SLACK + (2 + 2 * FLASH_FWD_STAGES) * cm
                + FLASH_FWD_STAGES * _BARRIER)
    if kind == "dq":    # Q and dO (128 rows each), the K/V ring, a barrier
        ring = 2 * FLASH_DQ_STAGES * cm + 3 * FLASH_DQ_STAGES * _BARRIER
        return _SMEM_SLACK + 4 * cm + ring + _BARRIER
    # two key tiles' K and V, the stages of Q, dO, lse and Delta
    return (_SMEM_SLACK + (4 + 2 * FLASH_DKV_STAGES) * cm
            + 2 * FLASH_DKV_STAGES * key * 4
            + (FLASH_DKV_STAGES + 1) * _BARRIER)


def attention_contracts(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                        *, dtype=torch.bfloat16,
                        window: Optional[int] = None,
                        kinds=("fwd", "dq", "dkv")) -> list:
    """The flash launches on q (b, hq, sq, d), k/v (b, hkv, sk, d): in
    bf16 the forward and dQ one block per (q head, example, 128-row q
    tile), dK/dV one per (work row of ``flash_attention.dkv_work``, kv
    head, example), two warpgroups each; in f32 one block per 64-row tile
    of the queries (keys for dK/dV)."""
    names = {"fwd": "flash_attention", "dq": "flash_attention_bwd_dq",
             "dkv": "flash_attention_bwd_dkv"}
    out = []
    bf16 = _c.dtype_name(dtype) == "bfloat16"
    key = _fa.KEY_TILE
    for kind in kinds:
        if bf16:
            grid = ((len(_fa.dkv_work(sq, sk, window)), hkv, b)
                    if kind == "dkv"
                    else (hq, b, -(-sq // FLASH_ROWS)))
            mma = ((_c.Wgmma(64, 32, 16, torch.bfloat16),
                    _c.Wgmma(64, d, 16, torch.bfloat16)) if kind == "dkv"
                   else (_c.Wgmma(64, key, 16, torch.bfloat16),
                         _c.Wgmma(64, d, 16, torch.bfloat16)))
            rows = key if kind == "dkv" else FLASH_ROWS
            box = (min(d, 64), rows, 1, 1) if d >= 64 \
                else (8, rows, d // 8, 1, 1)
            tma = _tma_maps(("q", "k"), ((b, hq, sq, d), (b, hkv, sk, d)),
                            (None, None), None, 2,
                            (box, (box[0], key) + box[2:]))
            out.append(_c.LaunchContract(
                names[kind], grid, 256, flash_smem_bytes(kind, d),
                2 if d <= 64 else 1,
                buffers=(_c.Buffer("acc", (64, d), torch.float32,
                                   where="regs", accumulator=True),),
                tma=tma, wgmma=mma,
                flops=_fa.flop_estimate(kind, b, hq, sq, sk, d, window),
                bytes=_fa.byte_estimate(kind, b, hq, hkv, sq, sk, d, 2)))
        else:
            n = -(-(sk if kind == "dkv" else sq) // key)
            out.append(_c.LaunchContract(
                names[kind], (n, hkv if kind == "dkv" else hq, b), _THREADS,
                flash_smem_bytes(kind, d, bf16=False),
                flops=_fa.flop_estimate(kind, b, hq, sq, sk, d, window),
                bytes=_fa.byte_estimate(kind, b, hq, hkv, sq, sk, d, 4)))
    return out


def contract_for_launch(name: str, shapes, dtypes, strides=None,
                        offsets=None, sms: int = _gn.SMS, **meta) -> list:
    """The contracts of one launch a trace recorded (``kernel_site``): the
    wrapper ``name`` on operands of these shapes, dtypes, element strides
    and storage offsets, on a card of ``sms`` SMs (the persistent grids
    depend on it)."""
    dt = getattr(torch, dtypes[0])
    st = tuple(strides) if strides is not None else (None,) * len(shapes)
    if name in ("gram_norm", "direct_norm"):
        (b, s, p_in), (_, _, p_out) = shapes
        kw = dict(dtype=dt, strides=st, offsets=offsets)
        if name == "gram_norm":
            return [gram_contract(b, s, p_in, p_out,
                                  triangular=meta.get("triangular", True),
                                  sms=sms, **kw)]
        return [direct_contract(b, s, p_in, p_out, **kw)]
    if name == "segmented_norm":
        (t, p_in), (_, p_out) = shapes[0], shapes[1]
        ids = _c.itemsize(getattr(torch, dtypes[2])) if len(dtypes) > 2 \
            else 4
        return segmented_contract(t, meta["n_seg"], p_in, p_out, dtype=dt,
                                  sms=sms, id_itemsize=ids)
    if name == "rowsumsq":
        return [rowsumsq_contract(*shapes[0], dtype=dt)]
    if name == "clip_scale":
        return [clip_scale_contract(*shapes[0], dtype=dt)]
    kind = {"flash_attention": "fwd", "flash_attention_bwd_dq": "dq",
            "flash_attention_bwd_dkv": "dkv"}[name]
    (b, hq, sq, d), (_, hkv, sk, _) = shapes[0], shapes[1]
    return attention_contracts(b, hq, hkv, sq, sk, d, dtype=dt,
                               window=meta.get("window"), kinds=(kind,))
