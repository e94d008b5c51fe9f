"""Plain PyTorch oracles for the CUDA kernels (the ``ref.py`` contract).

Port of ``src/repro/kernels/ref.py``: ``gram_norm_ref``, ``rowsumsq_ref``,
``clip_scale_ref`` and ``flash_attention_ref``. ``rowsumsq_ref`` and
``clip_scale_ref`` are also the plain versions of the ``rowsumsq`` and
``clip_scale`` kernels.
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


def rowsumsq_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., N) → (...) Σ x² over the last axis, in f32."""
    return torch.sum(torch.square(x.to(_F32)), dim=-1)


def clip_scale_ref(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Scale each example's rows: (B, ...) ⊙ c (B,) → z's shape and dtype.

    The product is taken in f32 and rounded once to z's dtype, as the
    TPU kernel's body does. The reference's ``clip_scale_ref`` casts c to
    z's dtype before the product instead, so in bf16 it can differ from
    both kernels by one rounding."""
    cb = c.to(_F32).reshape((-1,) + (1,) * (z.ndim - 1))
    return (z.to(_F32) * cb).to(z.dtype)


def flash_attention_ref(q, k, v, *, scale, softcap=None, window=None):
    """Oracle: plain causal GQA attention. q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D)
    → like q. Scores and softmax in f32."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_F32), k.to(_F32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask, s, -1.0e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(_F32)).to(q.dtype)
