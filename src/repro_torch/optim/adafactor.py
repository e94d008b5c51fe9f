"""Adafactor (Shazeer & Stern 2018): factored second moments — O(n+m)
optimizer state per (n×m) matrix instead of AdamW's O(2·n·m) f32.

Port of ``src/repro/optim/adafactor.py``: factored v for ≥2-D params,
update clipping by RMS, relative step size. As the port's AdamW does, the
update changes the moments and the parameters in place (under
``torch.no_grad``) and returns them; the step count is a Python int.

The update clipping and the relative step take one RMS per leaf. The
reference stacks a block's layers on one (L, ...) leaf, so there one RMS
spans all layers; the port keeps a leaf per layer, so each layer takes its
own. The reference's ``min_dim_factored``, which its update never reads
(every ≥2-D leaf is factored), is not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.nn.param import tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8           # t^-decay schedule for v's EMA
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    schedule: Optional[Callable[[int], float]] = None


class AdafactorState(NamedTuple):
    step: int
    vr: object    # row second-moments (or the full v for vectors)
    vc: object    # col second-moments (a 0-d zero for vectors)


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def init(params) -> AdafactorState:
    def rows(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=_F32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
        return torch.zeros(shape, dtype=_F32, device=p.device)

    return AdafactorState(0, tree_map(rows, params), tree_map(cols, params))


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-30)


@torch.no_grad()
def update(cfg: AdafactorConfig, state: AdafactorState, params, grads):
    """One Adafactor step; ``params`` and the state's moments change in
    place. Returns ``(params, new_state)``."""
    step = state.step + 1
    beta2 = 1.0 - float(step) ** (-cfg.decay)
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    for p, g, vr, vc in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.vr), tree_leaves(state.vc)):
        g = g.to(_F32)
        g2 = torch.square(g) + cfg.eps1
        if _factored(p):
            vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
            vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
            # v ≈ vr vcᵀ / mean(vr)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            r = (vr / torch.clamp(denom, min=cfg.eps1))[..., None]
            u = g * torch.rsqrt(r * vc[..., None, :] + cfg.eps1)
        else:
            vr.mul_(beta2).add_((1 - beta2) * g2)
            u = g * torch.rsqrt(vr + cfg.eps1)
        u = u / torch.clamp(_rms(u) / cfg.clip_threshold, min=1.0)
        pf = p.to(_F32)
        scale = torch.clamp(_rms(pf), min=cfg.eps2) if p.ndim >= 1 \
            else cfg.eps2
        new_p = pf - lr * scale * u
        if cfg.weight_decay:
            new_p -= lr * cfg.weight_decay * pf
        p.copy_(new_p)
    return params, AdafactorState(step, state.vr, state.vc)
