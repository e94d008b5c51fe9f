"""Gated / plain MLPs. Port of ``src/repro/nn/mlp.py``."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Tap
from repro_torch.dist.sharding import shard
from repro_torch.nn.linear import init_linear, linear


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d_model: int
    d_ff: int
    act: str = "silu"        # silu | gelu | relu2
    gated: bool = True


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def init_mlp(gen: torch.Generator, cfg: MlpCfg, *, dtype, device):
    p = {"up": init_linear(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                           device=device, axes=("embed", "mlp"))}
    if cfg.gated:
        p["gate"] = init_linear(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                device=device, axes=("embed", "mlp"))
    p["down"] = init_linear(gen, cfg.d_ff, cfg.d_model, dtype=dtype,
                            device=device, axes=("mlp", "embed"))
    return p


def mlp(p, x, *, tap: Tap, cfg: MlpCfg, group: str = "mlp"):
    up = linear(p["up"], x, tap=tap, group=group)
    if cfg.gated:
        g = linear(p["gate"], x, tap=tap, group=group)
        h = _act(cfg.act)(g) * up
    else:
        h = _act(cfg.act)(up)
    h = shard(h, "batch", None, "mlp_act")
    return shard(linear(p["down"], h, tap=tap, group=group),
                 "batch", None, "embed_act")
