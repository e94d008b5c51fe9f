"""Row-wise Σx² kernel: one f32 sum of squares per row of a (B, S, N) tensor.

Port of ``src/repro/kernels/rowsumsq.py`` to a CUDA kernel written for
Hopper (``csrc/rowsumsq.cu``; the note at its top says what bounds it and
what the design does about that). It feeds every per-token stat of the
token layout (``core.taps.TokenLayout``: ‖h_t‖²·‖z̄_t‖² for a dense tap,
‖h_t ⊙ z̄_t‖² for a scale tap, ‖z̄_t‖² for a bias or an embedding) and the
MLP-form norms of paper §6's one-pass clipping (``core.clipping``).

The TPU kernel took rows of a (B, N) array whose N its wrapper had
zero-padded to whole 2048-wide tiles; the CUDA kernel takes (B, S, N) rows
at any batch and sequence strides with a contiguous last axis, masks the
ragged end of a row itself, and makes no padded copy. One warp owns a row
narrower than 16,384 elements and one 256-thread block a wider one, so the
512-wide rows of wk/wv and the LM head's 128,256-wide rows both fill the
card.

The plain version is :func:`repro_torch.kernels.ref.rowsumsq_ref`;
``kernels.ops.rowsumsq`` picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_INT_MAX = 2**31 - 1
#: row width from which a 256-thread block owns a row (``kWideRow``)
WIDE_ROW = 16384


def flop_estimate(rows: int, n: int) -> float:
    """A square and an add per element."""
    return 2.0 * rows * n


def bytes_estimate(rows: int, n: int, itemsize: int) -> float:
    """Every element read once and one f32 written per row."""
    return float(rows) * (n * itemsize + 4)


def kernel_info(dtype, n: int) -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the body that takes rows of
    ``n`` elements of ``dtype`` (a warp a row below :data:`WIDE_ROW`, a
    block a row from it on), as the CUDA runtime reports them."""
    out = (ctypes.c_int * 5)()
    code = _build.load().rowsumsq_kernel_info(
        _build.DTYPE_CODES[str(dtype)], int(n >= WIDE_ROW), out)
    _build.check(code, "rowsumsq_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


def rowsumsq(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. x (B, S, N), float32 or bfloat16, on a CUDA
    device, any batch and sequence strides (a copy is made only when the
    last axis is not contiguous), no extent 0 → (B, S) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"rowsumsq: the kernel takes a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 3:
        raise ValueError(f"rowsumsq: expected x (B, S, N), got "
                         f"{tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("rowsumsq: empty input; ``kernels.ops.rowsumsq`` "
                         "answers it without a launch")
    b, s, n = x.shape
    if max(b, s, n, b * s) > _INT_MAX:
        raise ValueError(f"rowsumsq: {tuple(x.shape)} has more than 2^31-1 "
                         f"rows or elements per row")
    code = _build.dtype_code(x)
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((b, s), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.load().rowsumsq_launch(
        x.data_ptr(), out.data_ptr(), code, b, s, n, x.stride(0),
        x.stride(1), stream)
    _build.check(err, "rowsumsq")
    return out
