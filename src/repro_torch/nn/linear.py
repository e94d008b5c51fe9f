"""Dense layers — every matmul routes through the paper's tap so
per-example norms are first-class everywhere.

Port of ``src/repro/nn/linear.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.nn import lora as _lora
from repro_torch.nn import param as pm


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, dtype,
                device, axes=(None, None), bias: bool = False,
                std: Optional[float] = None):
    p = {"w": pm.normal(gen, (d_in, d_out), dtype, device, std, axes=axes)}
    if bias:
        p["b"] = pm.zeros((d_out,), dtype, device, axes=(axes[-1],))
    return p


def linear(p, x, *, tap: Tap, group: str = "all",
           method: Optional[str] = None) -> torch.Tensor:
    """Instrumented affine map. Plain matmul when the tap is inert.

    A site carrying a ``"lora"`` entry (see ``nn.lora``) freezes the base
    weight and bias: they are used detached, through a plain matmul with no
    tap (no gradient, no per-example stat), and the tapped low-rank delta
    is added on top. The base product is ``taps.matmul``: a checkpointed
    block under the ``"dots"`` policy keeps it as it keeps the tapped
    ones."""
    if "lora" in p:
        z = taps.matmul(x, p["w"].detach())
        if "b" in p:
            z = z + p["b"].detach()
        return z + _lora.delta(p["lora"], x, tap=tap, group=group,
                               method=method)
    z = tap.dense(x, p["w"], group=group, method=method)
    if "b" in p:
        z = tap.bias_add(z, p["b"], group=group)
    return z
