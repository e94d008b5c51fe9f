"""Segmented direct-norm kernel: per segment ||Σ_{t∈seg} h_t z̄_tᵀ||_F².

Port of ``src/repro/kernels/segmented_norm.py`` to a CUDA kernel written
for Hopper (``csrc/segmented_norm.cu``; the note at its top says what
bounds it and what the design does about that). The MoE expert taps need
the direct estimator over the rows of a capacity buffer: row t belongs to
segment seg(t), and segment j's partial gradient is
G_j = Σ_{t: seg(t)=j} h_t z̄_tᵀ.

As in the reference, the segment scatter becomes a sort: :func:`csr`
orders the rows by segment key (a stable argsort on the device, no host
sync) and turns the sorted keys into CSR offsets with ``searchsorted``.
Rows whose key lies outside ``[0, n_seg)`` (capacity padding, dropped
tokens) go to a drop bucket after the last segment and are never read.
The kernel reads the rows through the sort's permutation, so no sorted
copy of h or z̄ is made. One CUDA block per (128-wide p_in tile, 128-wide
p_out tile) walks the segments in order, keeps its tile of G_j in f32
registers while it sweeps segment j's rows, and squares and sums it into
a per-(segment, tile) partial; a second launch sums each segment's
partials in a fixed order. Nothing of size (n_seg, p_in, p_out) reaches
device memory.

Not carried over: the TPU wrapper's 128-lane padding of T, p_in and p_out
and its six scalar-prefetched (blk, r0, r1, seg, first, last) run tables;
ragged edges are masked at the load.

:func:`segmented_norm_ref` beside it is the plain version;
``kernels.ops.segmented_norm`` picks between the two by the tensors'
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_F32 = torch.float32


def drop_bucket(seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """int64 segment keys with every id outside [0, n_seg) sent to the
    drop bucket ``n_seg``."""
    seg = seg_ids.long()
    return torch.where((seg < 0) | (seg >= n_seg),
                       torch.full_like(seg, n_seg), seg)


def csr(seg_ids: torch.Tensor, n_seg: int):
    """(order, offsets): ``order`` (T,) int32 lists the rows sorted by
    segment key (stable); segment j owns sorted positions
    ``[offsets[j], offsets[j+1])`` of it, and ``offsets[n_seg]`` is the
    number of rows that are not dropped. Device ops only, no host sync."""
    key = drop_bucket(seg_ids, n_seg)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n_seg + 1, device=key.device, dtype=key.dtype)
    offsets = torch.searchsorted(key[order], bounds, out_int32=True)
    return order.to(torch.int32), offsets


def segmented_norm_ref(h: torch.Tensor, zbar: torch.Tensor,
                       seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Plain version: stable sort by key, then one f32 matmul
    ``H_segᵀ Z̄_seg`` per segment, squared and summed. h (T, p_in),
    zbar (T, p_out), seg_ids (T,) int → (n_seg,) f32."""
    order, offsets = csr(seg_ids, n_seg)
    h = h[order.long()].to(_F32)
    z = zbar[order.long()].to(_F32)
    bounds = offsets.tolist()
    out = torch.zeros((n_seg,), dtype=_F32, device=h.device)
    for j in range(n_seg):
        r0, r1 = bounds[j], bounds[j + 1]
        if r1 > r0:
            g = h[r0:r1].t() @ z[r0:r1]
            out[j] = torch.sum(torch.square(g))
    return out


def segment_sizes(seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(n_seg,) int64: the rows each segment keeps (dropped rows count in
    none)."""
    return torch.bincount(drop_bucket(seg_ids, n_seg),
                          minlength=n_seg + 1)[:n_seg]


def flop_estimate(seg_ids: torch.Tensor, n_seg: int, p_in: int,
                  p_out: int) -> float:
    """Operations this kernel does on the data: per non-empty segment of n
    rows, the direct form H_jᵀZ̄_j (2·n·p_in·p_out) and its square-and-sum
    (2·p_in·p_out). ``kernels.ops.segmented_flop_estimate`` gives the
    fewest the function needs."""
    n = segment_sizes(seg_ids, n_seg).double()
    return float(torch.sum(torch.where(
        n > 0, 2.0 * n * p_in * p_out + 2.0 * p_in * p_out, 0.0)))


def bytes_estimate(seg_ids: torch.Tensor, n_seg: int, p_in: int, p_out: int,
                   itemsize: int) -> float:
    """The kept rows of h and z̄ read once (dropped rows are never read),
    the T segment ids read once and the n_seg f32 norms written once."""
    n_valid = int(segment_sizes(seg_ids, n_seg).sum())
    return float(n_valid * (p_in + p_out) * itemsize
                 + seg_ids.numel() * seg_ids.element_size() + 4 * n_seg)


def segmented_norm(h: torch.Tensor, zbar: torch.Tensor,
                   seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Launch the CUDA kernel. h (T, p_in), zbar (T, p_out), both float32
    or both bfloat16, on one CUDA device, any row strides (a copy is made
    only when the feature axis is not contiguous); seg_ids (T,) int; no
    extent 0 and n_seg ≥ 1 → (n_seg,) float32."""
    if h.device.type != "cuda" or zbar.device != h.device \
            or seg_ids.device != h.device:
        raise ValueError(f"segmented_norm: the kernel takes CUDA tensors on "
                         f"one device, got {h.device}, {zbar.device} and "
                         f"{seg_ids.device}")
    if h.ndim != 2 or zbar.ndim != 2 or seg_ids.shape != h.shape[:1] \
            or zbar.shape[0] != h.shape[0]:
        raise ValueError(f"segmented_norm: expected h (T, p_in), zbar "
                         f"(T, p_out) and seg_ids (T,), got {tuple(h.shape)}, "
                         f"{tuple(zbar.shape)} and {tuple(seg_ids.shape)}")
    if h.dtype != zbar.dtype:
        raise TypeError(f"segmented_norm: h and zbar differ in dtype "
                        f"({h.dtype} vs {zbar.dtype})")
    if h.numel() == 0 or zbar.numel() == 0 or n_seg < 1:
        raise ValueError("segmented_norm: empty input; "
                         "``kernels.ops.segmented_norm`` answers it without "
                         "a launch")
    if h.stride(-1) != 1:
        h = h.contiguous()
    if zbar.stride(-1) != 1:
        zbar = zbar.contiguous()
    p_in, p_out = h.shape[1], zbar.shape[1]
    order, offsets = csr(seg_ids, n_seg)
    lib = _build.load()
    tiles = lib.segmented_norm_tiles(p_in, p_out)
    partial = torch.empty((n_seg, tiles), dtype=_F32, device=h.device)
    out = torch.empty((n_seg,), dtype=_F32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = lib.segmented_norm_launch(
        h.data_ptr(), zbar.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        partial.data_ptr(), out.data_ptr(), _build.dtype_code(h), n_seg,
        p_in, p_out, h.stride(0), zbar.stride(0), stream)
    _build.check(code, "segmented_norm")
    return out
