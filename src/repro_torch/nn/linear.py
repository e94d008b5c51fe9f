"""Dense layers — every matmul routes through the paper's tap so
per-example norms are first-class everywhere.

Port of ``src/repro/nn/linear.py``; the LoRA branch waits for the LoRA
slice."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, dtype,
                device, bias: bool = False, std: Optional[float] = None):
    p = {"w": pm.normal(gen, (d_in, d_out), dtype, device, std)}
    if bias:
        p["b"] = pm.zeros((d_out,), dtype, device)
    return p


def linear(p, x, *, tap: Tap, group: str = "all",
           method: Optional[str] = None) -> torch.Tensor:
    """Instrumented affine map. Plain matmul when the tap is inert."""
    z = tap.dense(x, p["w"], group=group, method=method)
    if "b" in p:
        z = tap.bias_add(z, p["b"], group=group)
    return z
