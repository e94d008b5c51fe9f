"""Importance-sampled optimization (Zhao & Zhang 2014) — the paper's §1
motivating application, built on the cheap per-example norms.

Port of ``src/repro/core/importance.py``. The variance-minimizing sampling
distribution for SGD is p_j ∝ ||∇L^(j)||. With the accumulator taps those
norms cost a forward and an activation backward over the candidate pool,
after which a minibatch is drawn and weighted by 1/(k·p_j), which keeps
the summed gradient unbiased.

This module is the sampling math; the fused execution is the
``Importance(k, ...)`` consumer of ``core.plan``: norms on the pool →
``sample`` → ``gather_batch`` → one reweighted backward on the sub-batch.

Draws: the reference draws from a JAX key, which PyTorch cannot
reproduce. The port draws from an explicit ``torch.Generator`` through one
draw site, :func:`_choice`, so that a test can hand both packages the same
indices; the port's own draws are checked by their frequencies. The draw
site marks its generator ``rng_use`` and ``sample`` marks the indices
``sample_idx`` (``core.provenance``), as the reference does.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.provenance import mark_rng, mark_sample
from repro_torch.nn.param import tree_leaves, tree_map


class ImportanceSample(NamedTuple):
    indices: torch.Tensor     # (k,) selected candidate rows
    weights: torch.Tensor     # (k,) unbiased importance weights
    probs: torch.Tensor       # (N,) the sampling distribution used


_DEGENERATE_MSG = ("importance.sampling_distribution: norm pool is "
                   "all-zero or non-finite; falling back to the uniform "
                   "distribution")


def sampling_distribution(sq_norms: torch.Tensor, smoothing: float = 0.0,
                          eps: float = 1e-12) -> torch.Tensor:
    """p_j ∝ ||g_j|| with optional uniform smoothing (p ← (1-λ)p + λ/N,
    which keeps the weights bounded).

    A degenerate pool — all-zero norms or any non-finite entry — falls
    back to the uniform distribution with a ``RuntimeWarning``. Deciding
    whether to warn reads one flag from the device."""
    if sq_norms.ndim == 2:
        sq_norms = torch.sum(sq_norms, dim=-1)
    norms = torch.sqrt(torch.clamp(sq_norms.to(torch.float32), min=0.0))
    total = torch.sum(norms)
    n = norms.shape[0]
    degenerate = ~torch.isfinite(total) | (total <= eps)
    if bool(degenerate):
        warnings.warn(_DEGENERATE_MSG, RuntimeWarning, stacklevel=2)
    p = torch.where(degenerate, torch.full_like(norms, 1.0 / n),
                    norms / torch.where(degenerate, 1.0, total + eps))
    if smoothing > 0.0:
        p = (1.0 - smoothing) * p + smoothing / n
    return p


def _choice(gen: torch.Generator, p: torch.Tensor, k: int,
            replace: bool) -> torch.Tensor:
    """k row indices drawn ∝ p from ``gen`` (on p's device): the one place
    an importance sample is drawn (its generator marked ``rng_use``)."""
    return torch.multinomial(p, k, replacement=replace,
                             generator=mark_rng(gen, purpose="importance"))


def sample(gen: torch.Generator, sq_norms: torch.Tensor, k: int,
           smoothing: float = 0.1, replace: bool = True) -> ImportanceSample:
    """Draw k examples ∝ gradient norm; the weights make the estimator of
    the batch sum unbiased: E[Σ_k v/(k·p)] = Σ v."""
    p = sampling_distribution(sq_norms, smoothing)
    idx = mark_sample(_choice(gen, p, k, replace), k=k)
    w = 1.0 / (k * p[idx] + 1e-12)
    return ImportanceSample(idx, w, p)


def gather_batch(batch, indices: torch.Tensor,
                 batch_size: Optional[int] = None):
    """Select rows ``indices`` from the leaves of a batch tree that carry
    the batch axis.

    Scalar and static leaves (mask flags, step counters, Python numbers)
    pass through untouched. A leaf is indexed iff it has rank ≥ 1 and its
    leading extent equals the batch size; when ``batch_size`` is not given
    it is inferred from the array leaves and must be unambiguous."""
    def is_arr(x):
        return hasattr(x, "ndim") and hasattr(x, "shape")

    if batch_size is None:
        sizes = {x.shape[0] for x in tree_leaves(batch)
                 if is_arr(x) and x.ndim >= 1}
        if len(sizes) > 1:
            raise ValueError(
                f"batch leaves carry different leading extents "
                f"{sorted(sizes)}; pass batch_size= to pick which leaves "
                f"hold the example axis")
        batch_size = sizes.pop() if sizes else None

    def take(x):
        if not (is_arr(x) and x.ndim >= 1 and x.shape[0] == batch_size):
            return x
        if isinstance(x, torch.Tensor):
            return x.index_select(0, indices.to(x.device))
        return np.take(x, indices.cpu().numpy(), axis=0)

    return tree_map(take, batch)


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = (Σw)²/Σw² — diagnostic for weight degeneracy."""
    return torch.square(torch.sum(weights)) / (
        torch.sum(torch.square(weights)) + 1e-12)
