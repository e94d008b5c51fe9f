"""Rotary position embeddings (standard RoPE, half-split convention).

Port of ``rope_angles`` and ``apply_rope`` from ``src/repro/nn/rotary.py``;
M-RoPE waits for qwen2-vl."""
from __future__ import annotations

from typing import Optional

import torch


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) int → angles (..., S, dim/2) f32."""
    inv = _inv_freq(dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               rot_dim: Optional[int] = None) -> torch.Tensor:
    """x (B, S, H, D); angles (B, S, rot/2) or (S, rot/2). Rotates the
    first ``rot_dim`` features (default: all), half-split convention."""
    d = x.shape[-1]
    rot = rot_dim or d
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)   # (B,S,1,rot/2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out
