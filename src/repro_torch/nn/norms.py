"""RMSNorm / LayerNorm with tapped (elementwise) scale parameters.

Port of ``src/repro/nn/norms.py``, gemma's ``(1 + g)`` form of RMSNorm
included."""
from __future__ import annotations

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm


def init_rmsnorm(d: int, *, dtype, device, plus_one: bool = False):
    # gemma parameterizes as (1 + g) with g init 0; others as g init 1
    init = pm.zeros if plus_one else pm.ones
    return {"g": init((d,), dtype, device, axes=("embed",))}


def rmsnorm(p, x, *, tap: Tap, eps: float = 1e-6, plus_one: bool = False,
            group: str = "norm") -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    xn = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                          + eps)
    # gemma's (1+g), formed in f32 and then rounded once, as the reference
    # does; the stat and grad w.r.t. g are unchanged by the constant shift
    g = (1.0 + p["g"].to(torch.float32)).to(dt) if plus_one else p["g"].to(dt)
    return tap.scale(xn.to(dt), g, group=group)


def init_layernorm(d: int, *, dtype, device):
    return {"g": pm.ones((d,), dtype, device, axes=("embed",)),
            "b": pm.zeros((d,), dtype, device, axes=("embed",))}


def layernorm(p, x, *, tap: Tap, eps: float = 1e-5,
              group: str = "norm") -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).to(dt)
    y = tap.scale(xn, p["g"].to(dt), group=group)
    return tap.bias_add(y, p["b"].to(dt), group=group)
