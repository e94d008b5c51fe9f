"""Error-feedback int8 gradient compression.

Port of the single-device part of ``src/repro/optim/grad_compress.py``:
each gradient tensor, plus the error carried from the last step, is
quantized to int8 with a per-tensor scale and restored, and what the
rounding lost is carried to the next step, so the optimizer stays unbiased
over time (Seide et al., 1-bit SGD lineage). ``TrainConfig.compress_grads``
runs it before the optimizer. Its use around the data-parallel all-reduce
waits for the port's distribution layer (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn.param import tree_flatten, tree_map, tree_unflatten

_F32 = torch.float32


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-tensor int8 quantization, guarded against a non-finite amax: a
    single NaN/inf element would otherwise poison the scale and turn the
    whole tensor into NaN on dequant. When amax is not finite the tensor
    is quantized as zeros and the caller keeps the uncompressed values for
    that step."""
    amax = torch.max(torch.abs(x))
    finite = torch.isfinite(amax)
    scale = torch.clamp(torch.where(finite, amax, 0.0), min=1e-12) / 127.0
    xq = torch.where(torch.isfinite(x) & finite, x, 0.0)
    q = torch.clamp(torch.round(xq / scale), -127, 127).to(torch.int8)
    return q, scale, finite


def compress_decompress(grads, err):
    """Returns (compressed-then-restored grads, new error feedback).

    A tensor whose amax is non-finite passes through uncompressed for that
    step and adds nothing to the error carry, so one bad step cannot
    poison later compressed steps through the feedback loop."""
    gs, treedef = tree_flatten(grads)
    out, new_err = [], []
    for g, e in zip(gs, tree_flatten(err)[0]):
        gf = g.to(_F32) + e
        q, s, finite = _quant(gf)
        deq = q.to(_F32) * s
        out.append(torch.where(finite, deq, gf).to(g.dtype))
        new_err.append(torch.where(finite, gf - deq, 0.0))
    return tree_unflatten(treedef, out), tree_unflatten(treedef, new_err)
