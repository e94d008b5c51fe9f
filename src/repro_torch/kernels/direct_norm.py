"""Direct per-example norm kernel: ||H_jᵀZ̄_j||_F² block by block.

Port of ``src/repro/kernels/direct_norm.py`` to a CUDA kernel written for
Hopper (``csrc/direct_norm.cu``; the note at its top says what bounds it and
what the design does about that). For bf16 inputs one CUDA block per (128
p_in columns, 256 p_out columns, example), launched p_in tile fastest, walks
the sequence in 64-row stages brought by TMA and keeps its tile of
G_j = H_jᵀZ̄_j in the tensor cores' f32 accumulators; at the end of the sweep
it squares and sums the tile into a per-block partial, and a second launch
sums each example's partials in a fixed order. f32 inputs run on the FMA
pipes in 128 × 128 tiles. Nothing of size (B, p_in, p_out) reaches device
memory, which matters most for the LM head (p_out = vocab).

The launcher decides each bf16 launch's copy route
(:func:`repro_torch.kernels._build.copy_route`) and counts it in
:data:`route_launches`; :func:`tiles` gives the block grid it allocates
partials for. As for the gram kernel, ragged S and feature edges read as
zero; the TPU wrapper's zero-padding copies are not carried over.

:func:`direct_norm_ref` beside it is the plain version (the port of
``core/norms.stat_direct``'s chunked loop); ``kernels.ops.direct_norm``
picks between the two by the tensors' device.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import _build

_F32 = torch.float32

#: columns of G per block of the bf16 body: (p_in, p_out) (``kInB``,
#: ``kOutB`` in csrc/direct_norm.cu), and of the f32 body
TILE = {torch.bfloat16: (128, 256), torch.float32: (128, 128)}

#: bf16 launches by copy route, as the launcher passed it: {("direct",
#: route): launches}
route_launches = collections.Counter()


def direct_norm_ref(h: torch.Tensor, zbar: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
    """Plain version: ||H_jᵀ Z̄_j||_F² in f32, chunked over p_in so that at
    most (B, chunk, p_out) of the per-example gradient exists at once.
    h (B, S, p_in), zbar (B, S, p_out) → (B,) f32."""
    b, _, p_in = h.shape
    chunk = max(1, min(chunk, p_in))
    z = zbar.to(_F32)
    out = torch.zeros((b,), dtype=_F32, device=h.device)
    for k in range(math.ceil(p_in / chunk)):
        hc = h[:, :, k * chunk:(k + 1) * chunk].to(_F32)
        g = torch.einsum("bsc,bso->bco", hc, z)
        out = out + torch.sum(torch.square(g), dim=(1, 2))
    return out


def flop_estimate(b: int, s: int, p_in: int, p_out: int) -> float:
    """The HᵀZ̄ contraction 2·S·p_in·p_out plus the square-and-sum
    (2 per element of G) for each example."""
    return float(b) * (2.0 * s * p_in * p_out + 2.0 * p_in * p_out)


def tiles(p_in: int, p_out: int, dtype) -> tuple:
    """(p_in tiles, p_out tiles) of a launch's block grid for ``dtype``."""
    t_in, t_out = TILE[dtype]
    return -(-p_in // t_in), -(-p_out // t_out)


def kernel_info() -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the bf16 body, as the CUDA
    runtime reports them."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.load().direct_norm_kernel_info(out),
                 "direct_norm_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


def direct_norm(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. h (B, S, p_in), zbar (B, S, p_out), both
    float32 or both bfloat16, on one CUDA device, any batch and sequence
    strides (a copy is made only when the feature axis is not contiguous),
    no extent 0 → (B,) float32."""
    h, zbar = _build.pair_inputs(h, zbar, "direct_norm")
    if h.numel() == 0 or zbar.numel() == 0:
        raise ValueError("direct_norm: empty input; "
                         "``kernels.ops.direct_norm`` answers it without a "
                         "launch")
    b, s, p_in = h.shape
    p_out = zbar.shape[-1]
    out = torch.empty((b,), dtype=torch.float32, device=h.device)
    n_in, n_out = tiles(p_in, p_out, h.dtype)
    partial = torch.empty((b, n_in * n_out), dtype=torch.float32,
                          device=h.device)
    route = None
    if h.dtype == torch.bfloat16:
        route = _build.copy_route(h, zbar)
        route_launches["direct", route] += 1
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = _build.load().direct_norm_launch(
        h.data_ptr(), zbar.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _build.dtype_code(h), b, s, p_in, p_out, h.stride(0), h.stride(1),
        zbar.stride(0), zbar.stride(1), int(route == "tma"), n_in * n_out,
        stream)
    _build.check(code, "direct_norm")
    return out
