"""Weights made from the seed, on the device, in a few large calls.

A schema is a nested dict (the port's parameter tree: dict keys, list
indices) whose leaves are ``Init(shape, dtype, kind, std)``. ``make``
draws one standard normal buffer per dtype from one ``torch.Generator``
seeded with the seed, in the dtype the model is served in, and hands each
leaf a contiguous view of it: ``normal`` leaves scaled by their std,
``ones`` and ``zeros`` filled. The same seed gives the same bits on the
same device, so the reference makes the program's starting point again
after the program has changed it in place.

Leaves are visited in sorted-key order (list indices in order), the order
in which the port flattens a tree.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Init:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    kind: str = "normal"          # normal | ones | zeros
    std: float = 1.0


def paths(tree, prefix=()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) pairs in the port's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from paths(x, prefix + (i,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


@torch.no_grad()
def make(schema, seed: int, device) -> dict:
    """The schema's tree of tensors on ``device``, drawn from ``seed``."""
    leaves = list(paths(schema))
    dtypes = []
    for _, init in leaves:
        if init.dtype not in dtypes:
            dtypes.append(init.dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    views = {}
    for dtype in dtypes:
        mine = [(p, i) for p, i in leaves if i.dtype == dtype]
        buf = torch.randn(sum(numel(i.shape) for _, i in mine),
                          generator=gen, dtype=dtype, device=device)
        at = 0
        for p, i in mine:
            n = numel(i.shape)
            v = buf[at:at + n].view(i.shape)
            at += n
            if i.kind == "normal":
                v.mul_(i.std)
            elif i.kind == "ones":
                v.fill_(1.0)
            elif i.kind == "zeros":
                v.zero_()
            else:
                raise ValueError(f"unknown init {i.kind!r} at {p}")
            views[p] = v

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(tree)]
        return views[prefix]
    return build(schema)
