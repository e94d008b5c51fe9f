"""Public wrappers around the CUDA kernels — what ``core.norms`` calls.

Port of the ``gram_norm`` / ``direct_norm`` wrappers of
``src/repro/kernels/ops.py``. Each wrapper takes the plain PyTorch version
for tensors on the CPU (the tests' device) and launches its CUDA kernel for
tensors on a CUDA device; any other device raises. There is no fallback
from the CUDA path to the plain version: a kernel that fails to build or
launch raises.

Each wrapper carries a plain integer launch counter (``gram_norm.launches``,
``direct_norm.launches``) that it raises by one where it launches its
kernel, and nowhere else, so a run can show which kernels its main path
went through. An empty input (a zero batch, sequence or feature extent)
has the norm 0 and launches nothing, so it is answered here and not
counted.

Not carried over: the TPU wrappers' 128-lane padding (``_launch_tiles``)
and the ``gram_cost``/``direct_cost`` prices of padded TPU tiles; the
port's dispatch uses the logical flop model in ``core.norms``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import direct_norm as _dn
from repro_torch.kernels import gram_norm as _gn
from repro_torch.kernels import ref as _ref


def _on_cpu(h: torch.Tensor, zbar: torch.Tensor, what: str) -> bool:
    devices = {h.device.type, zbar.device.type}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"{what}: h and zbar must both lie on the CPU or on a "
                     f"CUDA device, got {h.device} and {zbar.device}")


def _empty(h: torch.Tensor, zbar: torch.Tensor) -> bool:
    return h.numel() == 0 or zbar.numel() == 0


def _zeros(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((h.shape[0],), dtype=torch.float32, device=h.device)


def flop_estimate(b: int, s: int, p_in: int, p_out: int) -> float:
    """The fewest operations either kernel needs for ||H_jᵀZ̄_j||²_F on a
    (b, s, p) problem: the least work the function takes, whichever route
    the dispatch picks."""
    return min(_gn.flop_estimate(b, s, p_in, p_out),
               _dn.flop_estimate(b, s, p_in, p_out))


def gram_norm(h: torch.Tensor, zbar: torch.Tensor, *,
              triangular: bool = True) -> torch.Tensor:
    """(B,S,p_in),(B,S,p_out) → (B,) f32 Σ_{t,t'}<h_t,h_t'><z̄_t,z̄_t'>.

    ``triangular`` (default) visits only the upper triangle of sequence-
    tile pairs; ``False`` runs the full grid, kept for regression tests."""
    if _on_cpu(h, zbar, "gram_norm"):
        return _ref.gram_norm_ref(h, zbar)
    if _empty(h, zbar):
        return _zeros(h)
    out = _gn.gram_norm(h, zbar, triangular=triangular)
    gram_norm.launches += 1
    return out


gram_norm.launches = 0


def direct_norm(h: torch.Tensor, zbar: torch.Tensor) -> torch.Tensor:
    """(B,S,p_in),(B,S,p_out) → (B,) f32 ||H_jᵀZ̄_j||²_F."""
    if _on_cpu(h, zbar, "direct_norm"):
        return _dn.direct_norm_ref(h, zbar)
    if _empty(h, zbar):
        return _zeros(h)
    out = _dn.direct_norm(h, zbar)
    direct_norm.launches += 1
    return out


direct_norm.launches = 0


def reset_launch_counts() -> None:
    """Set every wrapper's launch counter to 0."""
    gram_norm.launches = 0
    direct_norm.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {"gram_norm": gram_norm.launches,
            "direct_norm": direct_norm.launches}
