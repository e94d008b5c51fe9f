"""Plain PyTorch oracles for the CUDA kernels (the ``ref.py`` contract).

Port of ``src/repro/kernels/ref.py``; this slice carries ``gram_norm_ref``
only. The other oracles (``rowsumsq_ref``, ``clip_scale_ref``,
``flash_attention_ref``) come with their kernels.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def gram_norm_ref(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """s_j = Σ_{t,t'} <h_t,h_t'><z̄_t,z̄_t'>  (== ||H_jᵀZ̄_j||_F²).

    h: (B, S, p_in), zbar: (B, S, p_out) → (B,) f32. Materializes the
    (B, S, S) Grams in f32.
    """
    h = h.to(_F32)
    zbar = zbar.to(_F32)
    hh = torch.einsum("bsi,bti->bst", h, h)
    zz = torch.einsum("bsi,bti->bst", zbar, zbar)
    return torch.sum(hh * zz, dim=(1, 2))
