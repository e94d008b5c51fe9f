"""AdamW with decoupled weight decay, f32 moments, global-norm clipping,
and schedule support.

Port of ``src/repro/optim/adamw.py``. The reference is functional; the
port updates the moments and the parameters in place (under
``torch.no_grad``) so that a step at full width allocates no second copy of
either, and returns them for the same calling convention. The update runs
over flat chunks of ``CHUNK`` elements of each leaf, so its f32
temporaries are bounded by a chunk and not by the largest leaf (a
160 × 5120 × 1536 expert leaf would make each 5 GB). The arithmetic is
elementwise, so a chunk gives the same bits as the whole leaf.

DTensor leaves (the model-axis route): the moments are laid out as their
parameters, the update runs on each rank's local shards (the chunks taken
over the local shard), and the global norm sums each rank's local squares
once over the mesh (a replicated leaf counted on one coordinate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import spans
from repro_torch.dist.sharding import is_dtensor
from repro_torch.nn.param import tree_leaves, tree_map

#: elements of each flat slice the update runs over (256 MiB of f32)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    global_clip: Optional[float] = 1.0
    schedule: Optional[Callable[[int], float]] = None


class AdamWState(NamedTuple):
    step: int
    mu: object
    nu: object


def init(params) -> AdamWState:
    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    mesh = next((x.device_mesh for x in leaves if is_dtensor(x)), None)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    coord = mesh.get_coordinate()
    total = 0.0
    for x in leaves:
        sq = torch.sum(torch.square(x.to_local().to(torch.float32)))
        # a leaf replicated over a mesh dim counts on its first coordinate
        if any(isinstance(p, Replicate) and c != 0
               for p, c in zip(x.placements, coord)):
            sq = torch.zeros_like(sq)
        total = total + sq
    return torch.sqrt(DTensor.from_local(
        total, mesh, [Partial()] * mesh.ndim, run_check=False).full_tensor())


def update(cfg: AdamWConfig, state: AdamWState, params, grads):
    """One AdamW step; ``params`` and the state's moments change in
    place, so each of their leaves must be contiguous (``init`` and
    ``interop`` make them so); a gradient leaf may be any layout. Returns
    ``(params, new_state)``."""
    with spans.span("adamw.update"):
        return _update(cfg, state, params, grads)


@torch.no_grad()
def _update(cfg: AdamWConfig, state: AdamWState, params, grads):
    for p, m, v in zip(tree_leaves(params), tree_leaves(state.mu),
                       tree_leaves(state.nu)):
        p, m, v = (x.to_local() if is_dtensor(x) else x for x in (p, m, v))
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"adamw.update: a parameter leaf of shape "
                             f"{tuple(p.shape)} or its moments is not "
                             f"contiguous; the update changes them in place "
                             f"through flat views")
    step = state.step + 1
    scale = 1.0
    if cfg.global_clip is not None:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.global_clip / (gn + 1e-9), max=1.0)
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p_, g_, m_, v_ in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
        if is_dtensor(p_):
            # the local shards, the gradient laid out as its parameter
            if tuple(g_.placements) != tuple(p_.placements):
                g_ = g_.redistribute(p_.device_mesh, p_.placements)
            p_, g_, m_, v_ = (x.to_local() for x in (p_, g_, m_, v_))
        # p, m and v change in place, so they must be flat views; g is read
        p_, m_, v_, g_ = p_.view(-1), m_.view(-1), v_.view(-1), g_.reshape(-1)
        for i in range(0, p_.numel(), CHUNK):
            p, g, m, v = (x[i:i + CHUNK] for x in (p_, g_, m_, v_))
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            pf = p.to(torch.float32)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    return params, AdamWState(step, state.mu, state.nu)
