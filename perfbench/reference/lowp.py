"""The control's matrix product: the reference computed in FP8, the
precision below the bfloat16 that the configurations state.

``fp8_mm(a, b)`` rounds both operands to float8 e4m3 (each tensor scaled
so that its largest magnitude maps to e4m3's largest, 448) and multiplies
the rounded values in float32; its backward rounds the incoming gradient
to float8 e5m2 the same way and forms both products from rounded operands,
as FP8 training recipes do. Only the products of the linear layers and
the experts take it; norms, softmax, attention's own products and the
optimizer stay float32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _round(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = _round(grad, torch.float8_e5m2, E5M2_MAX)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.reshape(-1, qa.shape[-1]).transpose(0, 1),
                          qg.reshape(-1, qg.shape[-1]))
        return ga, gb.reshape(qb.shape)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(a, b)
