"""The paper's §3 naive method — kept as the numerical oracle.

Port of ``src/repro/core/naive.py`` with ``torch.func``: backprop once per
example, vectorized with ``vmap(grad(...))``. It materializes the full
per-example gradient tree — the O(m·n·p²) memory the paper's method avoids —
so it is for small models.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.nn.param import tree_leaves


def per_example_grads(loss_fn: Callable, params, batch):
    """Per-example parameter gradients.

    loss_fn(params, example) -> scalar loss for that one example (its
    leaves without the batch axis). Returns a tree matching params with a
    leading batch axis."""
    return vmap(grad(loss_fn), in_dims=(None, 0))(params, batch)


def per_example_sq_norms(loss_fn: Callable, params, batch) -> torch.Tensor:
    """(B,) vector of ||∂L^(j)/∂θ||² via the naive method (paper §3)."""
    return per_example_grad_tree_norms(
        per_example_grads(loss_fn, params, batch))


def per_example_grad_tree_norms(grads) -> torch.Tensor:
    """Squared norms from an already-materialized per-example grad tree."""
    return sum(torch.sum(torch.square(g.to(torch.float32)),
                         dim=tuple(range(1, g.ndim)))
               for g in tree_leaves(grads))
