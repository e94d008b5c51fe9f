"""Parameters between the JAX reference's layout and the port's.

The input of :func:`params_from_numpy` is a nested dict of numpy arrays
shaped like the reference's parameters after ``unbox`` and ``np.asarray``
(the caller does that conversion on the JAX side). The reference stacks
the layers of its homogeneous stacks (``STACKS``: ``blocks``, zamba2's
``tail``, seamless's ``enc`` and ``dec``) on a leading (L, ...) axis for
``lax.scan``; the port keeps a list of L per-layer dicts. zamba2 stacks
its grouped blocks on two axes, (G, K, ...), which the port keeps as a
list of G lists of K dicts: a tree with a ``shared`` block is zamba2's.
Every other subtree (deepseek's ``prefix`` list among them) is carried
as it is, and no leaf outside a stack is split. :func:`params_to_numpy`
is the inverse.

A LoRA site's factors arrive as the reference's ``LoraPair`` (numpy ``a``,
``b`` and a float ``alpha``), recognized by those three attributes (the
port does not import the reference's class) and carried into the port's
``nn.lora.LoraPair``; stacked (L, d, r) factors of ``blocks`` are split
into per-layer pairs as the weights are.

:func:`caches_from_numpy` and :func:`caches_to_numpy` carry serving
caches (a family's ``init_caches`` tree) the same way: the reference stacks
each layer's cache on the leading axes its stack has (``CACHE_STACKS``),
the port keeps one dict per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.lora import LoraPair
from repro_torch.nn.param import resolve_device, tree_map


def _to_tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":   # ml_dtypes bf16: no torch equivalent
        return torch.as_tensor(x.astype(np.float32), device=device) \
            .to(torch.bfloat16)
    return torch.tensor(x, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _carry_pairs(tree):
    """``tree`` with every LoRA pair (the reference's, by its attributes)
    rebuilt as the port's ``LoraPair``."""
    if isinstance(tree, dict):
        return {k: _carry_pairs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_carry_pairs(v) for v in tree]
    if all(hasattr(tree, k) for k in ("a", "b", "alpha")):
        return LoraPair(tree.a, tree.b, tree.alpha)
    return tree


#: the top-level subtrees the reference stacks on leading layer axes
STACKS = ("blocks", "tail", "enc", "dec")


def _depth(tree, key) -> int:
    """Leading layer axes of ``tree[key]``: two for zamba2's grouped blocks
    (the tree that has the shared block), one otherwise."""
    return 2 if key == "blocks" and "shared" in tree else 1


def _split_layers(stacked):
    """{..., leaf (L, ...)} → [{..., leaf (...)} for each of the L layers]."""
    if isinstance(stacked, LoraPair):
        return [LoraPair(a, b, stacked.alpha)
                for a, b in zip(stacked.a, stacked.b)]
    if isinstance(stacked, dict):
        parts = {k: _split_layers(v) for k, v in stacked.items()}
        n = {len(v) for v in parts.values()}
        if len(n) != 1:
            raise ValueError(f"stacked block leaves disagree on the layer "
                             f"count: {sorted(n)}")
        return [{k: v[i] for k, v in parts.items()} for i in range(n.pop())]
    return list(stacked)


def _stack_layers(layers):
    """Inverse of :func:`_split_layers`."""
    if isinstance(layers[0], LoraPair):
        return LoraPair(np.stack([lay.a for lay in layers]),
                        np.stack([lay.b for lay in layers]), layers[0].alpha)
    if isinstance(layers[0], dict):
        return {k: _stack_layers([lay[k] for lay in layers])
                for k in layers[0]}
    return np.stack(layers)


def _split(stacked, depth: int):
    """``depth`` leading layer axes → nested lists of per-layer trees."""
    layers = _split_layers(stacked)
    return layers if depth == 1 else [_split(x, depth - 1) for x in layers]


def _stack(layers):
    """Inverse of :func:`_split`: nested lists stack on as many axes."""
    if isinstance(layers[0], list):
        layers = [_stack(x) for x in layers]
    return _stack_layers(layers)


def params_from_numpy(tree, device=None):
    """Reference-layout numpy tree → port params (torch tensors on
    ``device``, default CUDA)."""
    device = resolve_device(device)
    tree = _carry_pairs(tree)
    out = {}
    for k, v in tree.items():
        if k in STACKS:
            v = _split(v, _depth(tree, k))
        out[k] = tree_map(lambda x: _to_tensor(x, device), v)
    return out


def params_to_numpy(params):
    """Port params → reference-layout numpy tree (the ``STACKS`` lists
    stacked). A LoRA pair stays the port's ``LoraPair``, with numpy factors
    (stacked for ``blocks``): the caller on the JAX side rebuilds it as the
    reference's from its ``a``, ``b`` and ``alpha``."""
    out = {}
    for k, v in params.items():
        v = tree_map(_to_numpy, v)
        out[k] = _stack(v) if k in STACKS else v
    return out


#: per family, the subtrees of the reference's serving caches stacked on
#: leading layer axes, by key path, with their number of axes (an empty
#: path: the whole tree); every other leaf (deepseek's ``prefix`` list,
#: seamless's ``memory``) is carried as it is
CACHE_STACKS = {"transformer": {("blocks",): 1},
                "rwkv6": {(): 1},
                "zamba2": {("states", "blocks"): 2, ("states", "tail"): 1,
                           ("shared",): 1},
                "seamless": {("self",): 1, ("cross",): 1}}


def _carry_caches(tree, family, stacked, leaf, path=()):
    """``tree`` with each stacked subtree of ``family`` (``CACHE_STACKS``)
    passed to ``stacked(subtree, depth)`` and every other leaf to
    ``leaf``."""
    depth = CACHE_STACKS[family].get(path)
    if tree is None:
        return None
    if depth is not None:
        return stacked(tree, depth)
    if isinstance(tree, dict):
        return {k: _carry_caches(v, family, stacked, leaf, path + (k,))
                for k, v in tree.items()}
    return tree_map(leaf, tree)


def caches_from_numpy(tree, family: str, device=None):
    """The reference's serving caches of a ``family`` (transformer, rwkv6,
    zamba2 or seamless) as numpy, layers stacked → the port's layout
    (``models.<family>.init_caches``), tensors on ``device`` (default
    CUDA)."""
    device = resolve_device(device)

    def leaf(x):
        return _to_tensor(x, device)
    return _carry_caches(tree, family,
                         lambda t, depth: tree_map(leaf, _split(t, depth)),
                         leaf)


def caches_to_numpy(caches, family: str):
    """Inverse of :func:`caches_from_numpy`: the port's caches → numpy in
    the reference's layout, layers stacked."""
    return _carry_caches(caches, family,
                         lambda t, depth: _stack(tree_map(_to_numpy, t)),
                         _to_numpy)
