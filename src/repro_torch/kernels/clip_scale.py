"""Row-rescale kernel: z'_j = c_j · z_j, paper §6's Z̄ modification.

Port of ``src/repro/kernels/clip_scale.py`` to a CUDA kernel written for
Hopper (``csrc/clip_scale.cu``; the note at its top says what bounds it and
what the design does about that). The one-pass clipping of
``core.clipping`` rescales every tapped layer's Z̄ by the per-example clip
coefficients through it before it recomputes W̄' = Xᵀ(c ⊙ Z̄).

The TPU kernel read c from SMEM by scalar prefetch and streamed
(tile_s × tile_p) blocks of a (B, S, p) array its wrapper had zero-padded
to whole tiles; the CUDA kernel takes z at any batch and sequence strides
with a contiguous last axis, writes a new contiguous tensor, and makes no
padded copy. Each element is multiplied in f32 and rounded once to z's
dtype, as the Pallas body does, so the kernel equals its plain version
exactly.

The plain version is :func:`repro_torch.kernels.ref.clip_scale_ref`;
``kernels.ops.clip_scale`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_INT_MAX = 2**31 - 1


def flop_estimate(numel: int) -> float:
    """One multiply per element."""
    return float(numel)


def bytes_estimate(numel: int, b: int, itemsize: int) -> float:
    """z read once, z' written once, c (b f32) read once."""
    return float(2 * numel * itemsize + 4 * b)


def kernel_info(dtype) -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the body of ``dtype``, as the
    CUDA runtime reports them."""
    out = (ctypes.c_int * 5)()
    code = _build.load().clip_scale_kernel_info(
        _build.DTYPE_CODES[str(dtype)], out)
    _build.check(code, "clip_scale_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


def clip_scale(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. z (B, S, N), float32 or bfloat16, any batch
    and sequence strides (a copy is made only when the last axis is not
    contiguous); c (B,) on the same CUDA device, taken in float32; no
    extent 0 → (B, S, N) contiguous, z's dtype."""
    if z.device.type != "cuda" or c.device != z.device:
        raise ValueError(f"clip_scale: the kernel takes CUDA tensors on one "
                         f"device, got {z.device} and {c.device}")
    if z.ndim != 3 or c.shape != z.shape[:1]:
        raise ValueError(f"clip_scale: expected z (B, S, N) and c (B,), got "
                         f"{tuple(z.shape)} and {tuple(c.shape)}")
    if z.numel() == 0:
        raise ValueError("clip_scale: empty input; ``kernels.ops.clip_scale`` "
                         "answers it without a launch")
    b, s, n = z.shape
    if max(b, s, n, b * s) > _INT_MAX:
        raise ValueError(f"clip_scale: {tuple(z.shape)} has more than 2^31-1 "
                         f"rows or elements per row")
    code = _build.dtype_code(z)
    if z.stride(-1) != 1:
        z = z.contiguous()
    c = c.to(torch.float32).contiguous()
    out = torch.empty((b, s, n), dtype=z.dtype, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _build.load().clip_scale_launch(
        z.data_ptr(), c.data_ptr(), out.data_ptr(), code, b, s, n,
        z.stride(0), z.stride(1), stream)
    _build.check(err, "clip_scale")
    return out
