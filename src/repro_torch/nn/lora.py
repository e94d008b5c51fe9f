"""LoRA adapters over the tapped linear layers (DESIGN.md §14).

Port of ``src/repro/nn/lora.py``. A LoRA site replaces the trainable
weight of one ``nn.linear`` site with a frozen base plus a low-rank
trainable delta:

    z = x @ W.detach()  +  (α/r) · (x @ A) @ B

Both factors route through the tap (``tap.dense``, or ``tap.dense_batched``
when the factors carry a leading per-example axis: the multi-tenant
gather), so per-example gradient norms on the adapters are exact. The
(α/r) scale is applied AFTER the second factor, so the cotangent arriving
at each tap already carries it and the stats describe the true (scaled)
adapter gradients.

``LoraPair`` is a tree node of ``nn.param``'s helpers (children ``(a, b)``,
static ``alpha``), so adapters survive ``tree_map``, the optimizers, the
noise add and ``count_params`` unchanged. The reference stacks the blocks'
factors on a leading (L, ...) axis; the port keeps ``blocks`` as a list,
so each layer's site gets its own pair, seeded from its path (layer index
included) as the reference folds its key from the site path.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Tuple

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm

#: default sites: every projection the transformer family routes through
#: ``nn.linear`` (attention + MLP)
DEFAULT_SITES = ("wq", "wk", "wv", "wo", "up", "gate", "down")


@dataclasses.dataclass(frozen=True)
class LoraCfg:
    """Static LoRA policy (lives inside ``LMConfig``).

    rank:            default adapter rank r.
    alpha:           scale numerator — the delta is (α/r)·AB.
    sites:           site names (the dict key holding the ``{"w": ...}``
                     linear params) that get adapters.
    rank_overrides:  ((site, rank), ...) per-site rank exceptions.
    """
    rank: int = 8
    alpha: float = 16.0
    sites: Tuple[str, ...] = DEFAULT_SITES
    rank_overrides: Tuple[Tuple[str, int], ...] = ()

    def rank_for(self, site: str) -> int:
        for name, r in self.rank_overrides:
            if name == site:
                return r
        return self.rank


class LoraPair:
    """One site's adapter factors: ``a`` (..., d_in, r), ``b``
    (..., r, d_out), with any shared leading axes (tenant rows)."""

    __slots__ = ("a", "b", "alpha")

    def __init__(self, a, b, alpha: float):
        self.a = a
        self.b = b
        self.alpha = float(alpha)

    def tree_flatten(self):
        return (self.a, self.b), self.alpha

    @classmethod
    def tree_unflatten(cls, alpha, children):
        return cls(children[0], children[1], alpha)

    @property
    def rank(self) -> int:
        return self.a.shape[-1]

    def __repr__(self):
        return (f"LoraPair(a={tuple(getattr(self.a, 'shape', ()))}, "
                f"alpha={self.alpha})")


def init_pair(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              alpha: float, *, dtype=torch.float32, device=None,
              lead: Tuple[int, ...] = (),
              b_std: Optional[float] = None) -> LoraPair:
    """Standard LoRA init from ``gen``: A ~ N(0, 1/√d_in), B = 0 (the
    delta starts at zero), or B ~ N(0, ``b_std``) when ``b_std`` > 0 (tests
    that need non-zero adapter gradients from step 0). ``lead`` prepends
    shared axes."""
    device = pm.resolve_device(device)
    lead = tuple(lead)
    a = pm.normal(gen, lead + (d_in, rank), dtype, device,
                  std=1.0 / math.sqrt(max(1, d_in)))
    if b_std and b_std > 0.0:
        b = pm.normal(gen, lead + (rank, d_out), dtype, device, std=b_std)
    else:
        b = pm.zeros(lead + (rank, d_out), dtype, device)
    return LoraPair(a, b, alpha)


def delta(pair: LoraPair, x, *, tap: Tap, group: str = "all",
          method: Optional[str] = None) -> torch.Tensor:
    """(α/r)·(x @ A) @ B through the tap. Factors with a leading
    per-example axis (``a.ndim == 3`` against a 3-D x of the same leading
    extent: the multi-tenant gathered form) go through
    ``tap.dense_batched``; the shared form through ``tap.dense``. The scale
    multiplies the *output*, so the taps see the true scaled cotangents."""
    a, b = pair.a, pair.b
    scale = pair.alpha / pair.rank
    if a.ndim == x.ndim == 2 or (a.ndim == 3 and x.ndim == 3
                                 and a.shape[0] == x.shape[0]):
        # ambiguous only in the (a 3-D, x 3-D) case: leading axes match
        # ⇒ per-example factors
        batched = a.ndim == 3
    else:
        batched = a.ndim == x.ndim
    if batched and a.ndim >= 3:
        h_r = tap.dense_batched(x, a, group=group, method=method)
        d = tap.dense_batched(h_r, b, group=group, method=method)
    else:
        h_r = tap.dense(x, a, group=group, method=method)
        d = tap.dense(h_r, b, group=group, method=method)
    return scale * d


def _site_seed(seed: int, path) -> int:
    """The seed of the site at ``path``: ``seed`` folded with the crc32 of
    each part (not ``hash()``, which is randomized per process)."""
    for part in path:
        seed = pm.fold_seed(seed, zlib.crc32(str(part).encode())
                            & 0x7FFFFFFF)
    return seed


def attach(params, cfg: LoraCfg, seed: int, *, dtype=torch.float32,
           device=None):
    """Add ``"lora"`` entries to every matching linear-site dict of a
    parameter tree. A site matches when its dict key is in ``cfg.sites``
    and it holds a ``"w"`` leaf; the factors take the weight's leading
    axes. Each site draws from a generator seeded from ``seed`` and its
    path, so attach order and dict iteration order do not matter."""
    device = pm.resolve_device(device)

    def rec(node, path):
        if isinstance(node, dict):
            out = {}
            for name in node:
                child = node[name]
                if (name in cfg.sites and isinstance(child, dict)
                        and "w" in child):
                    w = child["w"]
                    gen = torch.Generator(device=device).manual_seed(
                        _site_seed(seed, path + (name,)))
                    out[name] = dict(child)
                    out[name]["lora"] = init_pair(
                        gen, w.shape[-2], w.shape[-1], cfg.rank_for(name),
                        cfg.alpha, dtype=dtype, device=device,
                        lead=tuple(w.shape[:-2]))
                else:
                    out[name] = rec(child, path + (name,))
            return out
        if isinstance(node, list):
            return [rec(c, path + (i,)) for i, c in enumerate(node)]
        return node

    return rec(params, ())


def adapter_tree(params) -> dict:
    """The trainable adapter subtree: {path: LoraPair} keyed by '/'-joined
    site paths (the layer index of ``blocks`` included)."""
    out = {}

    def rec(node, path):
        if isinstance(node, LoraPair):
            out["/".join(str(p) for p in path)] = node
            return
        if isinstance(node, dict):
            for name, child in node.items():
                rec(child, path + (name,))
        elif isinstance(node, list):
            for i, child in enumerate(node):
                rec(child, path + (i,))

    rec(params, ())
    return out


def merge_adapters(params, adapters: dict):
    """Inverse of :func:`adapter_tree`: place each pair back at its path
    (returns a new tree; the input is not changed)."""
    def rec(node, path):
        if isinstance(node, LoraPair):
            return adapters.get("/".join(str(p) for p in path), node)
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return rec(params, ())
