"""RMSNorm with a tapped (elementwise) scale parameter.

Port of ``rmsnorm`` from ``src/repro/nn/norms.py``; LayerNorm and gemma's
``(1 + g)`` form come with the models that use them."""
from __future__ import annotations

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm


def init_rmsnorm(d: int, *, dtype, device):
    return {"g": pm.ones((d,), dtype, device)}


def rmsnorm(p, x, *, tap: Tap, eps: float = 1e-6,
            group: str = "norm") -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    xn = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                          + eps)
    return tap.scale(xn.to(dt), p["g"].to(dt), group=group)
