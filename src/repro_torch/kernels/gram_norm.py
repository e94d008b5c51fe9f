"""Tile-pair Gram kernel: per-example ||H_jᵀZ̄_j||_F² without the S×S Gram.

Port of ``src/repro/kernels/gram_norm.py`` to a CUDA kernel written for
Hopper (``csrc/gram_norm.cu``; the note at its top says what bounds it and
what the design does about that). The identity

    s_j = Σ_{t,t'} <h_t, h_t'> <z̄_t, z̄_t'>

is evaluated tile pair by tile pair: one CUDA block per (example, pair of
64-row sequence tiles) builds the H-Gram and Z̄-Gram tiles in f32 registers,
chunked over each tensor's own feature axis, and folds their elementwise
product into a per-block partial; a second launch sums the partials of each
example in a fixed order. ``triangular=True`` (the default) visits only the
upper triangle and weights off-diagonal pairs by 2; ``triangular=False``
visits the full grid and is the regression oracle for that halving.

What the TPU wrapper did that the port does not: zero-padding S and the
feature axes to 128-lane tiles (``ops.py``'s ``_launch_tiles``). The CUDA
kernel masks ragged edges at the load instead.

The plain version is :func:`repro_torch.kernels.ref.gram_norm_ref`;
``kernels.ops.gram_norm`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: sequence rows per tile (``kTile`` in csrc/gram_norm.cu)
TILE_S = 64


def flop_estimate(b: int, s: int, p_in: int, p_out: int, *,
                  triangular: bool = True) -> float:
    """Multiply-adds ×2 the kernel does on a logical (b, s, p) problem: the
    two Gram tiles of every visited pair (ragged last tile counted at its
    true height) plus the fold."""
    n = -(-s // TILE_S)
    rows = [min(TILE_S, s - i * TILE_S) for i in range(n)]
    work = 0.0
    for i in range(n):
        for j in range(i if triangular else 0, n):
            work += 2.0 * rows[i] * rows[j] * (p_in + p_out + 1)
    return float(b) * work


def gram_norm(h: torch.Tensor, zbar: torch.Tensor, *,
              triangular: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. h (B, S, p_in), zbar (B, S, p_out), both
    float32 or both bfloat16, on one CUDA device, any batch and sequence
    strides (a copy is made only when the feature axis is not contiguous),
    no extent 0 → (B,) float32."""
    h, zbar = _build.pair_inputs(h, zbar, "gram_norm")
    if h.numel() == 0 or zbar.numel() == 0:
        raise ValueError("gram_norm: empty input; ``kernels.ops.gram_norm`` "
                         "answers it without a launch")
    b, s, p_in = h.shape
    p_out = zbar.shape[-1]
    out = torch.zeros((b,), dtype=torch.float32, device=h.device)
    lib = _build.load()
    blocks = lib.gram_norm_blocks(s, int(triangular))
    partial = torch.empty((b, blocks), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = lib.gram_norm_launch(
        h.data_ptr(), zbar.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _build.dtype_code(h), b, s, p_in, p_out, h.stride(0), h.stride(1),
        zbar.stride(0), zbar.stride(1), int(triangular), stream)
    _build.check(code, "gram_norm")
    return out
