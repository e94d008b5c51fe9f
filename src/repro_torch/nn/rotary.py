"""Rotary position embeddings: standard RoPE (half-split convention),
partial RoPE and Qwen2-VL's multimodal M-RoPE (per-section t/h/w streams).

Port of ``src/repro/nn/rotary.py``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) int → angles (..., S, dim/2) f32."""
    inv = _inv_freq(dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def mrope_angles(positions: torch.Tensor, dim: int, theta: float,
                 sections: Sequence[int]) -> torch.Tensor:
    """M-RoPE: positions (3, B, S), the temporal/height/width streams →
    angles (B, S, dim/2) f32. ``sections`` are in half-dim units and sum to
    dim/2 (qwen2-vl: 16/24/24 at head_dim 128); each frequency band takes
    its angle from its section's stream."""
    if positions.shape[0] != 3 or sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE needs (3, B, S) positions and sections "
                         f"summing to {dim // 2}, got {tuple(positions.shape)}"
                         f" and {tuple(sections)}")
    full = rope_angles(positions, dim, theta)        # (3, B, S, dim/2)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(full[i, ..., off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


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
