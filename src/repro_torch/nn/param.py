"""Parameters: initializers, the device rule, and tree helpers.

Port of ``src/repro/nn/param.py``. The reference boxes every leaf with its
logical sharding axes (``Boxed``); the port keeps parameters plain tensors
in a nested dict (and list) and carries the axes beside them: every
initializer takes the leaf's logical axes (``("embed", "heads")``, one
name or None per dim) and stamps them on the tensor it returns
(:func:`box`), and :func:`axes_of` reads them back as a tree parallel to
the parameter tree, the reference's ``axes_of`` after ``unbox``. The
reference stacks its layers on a leading axis; the port keeps one leaf per
layer, so a per-layer leaf's axes are the reference's without that axis.
``dist.sharding.distribute_tree`` turns the axes tree into DTensor
placements under a rules context. A tensor made by another op than an
initializer carries no axes; :func:`param_axes` re-runs an ``init`` on
``meta`` for a tree that lost them (one converted by ``interop``).

The one node of another kind is a LoRA site's ``nn.lora.LoraPair``
(:func:`is_node`), which the tree helpers walk as the reference's pytree
registration makes JAX walk it. Initializers draw from an explicit
``torch.Generator`` on an explicit device, with the reference's
distributions (fan-in std for matrices unless given).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent, so
    nothing quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and an integer datum, by a fixed
    integer mix (splitmix64's finalizer): the port's counterpart of the
    reference's ``jax.random.fold_in`` for ``torch.Generator`` seeds. The
    same pair gives the same seed in every process; nearby data give
    unrelated seeds."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data)
         + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]


#: the attribute :func:`box` stamps a leaf's logical axes under
AXES_ATTR = "logical_axes"


def box(t: torch.Tensor, axes=None) -> torch.Tensor:
    """Stamp ``t`` with its logical axes (one name or None per dim; None ⇒
    every dim replicated) and return it: the port's ``Boxed``."""
    axes = (None,) * t.ndim if axes is None else tuple(axes)
    if len(axes) != t.ndim:
        raise ValueError(f"logical axes {axes} do not match a "
                         f"{t.ndim}-d parameter of shape {tuple(t.shape)}")
    setattr(t, AXES_ATTR, axes)
    return t


def normal(gen: torch.Generator, shape, dtype: torch.dtype, device,
           std: Optional[float] = None, axes=None) -> torch.Tensor:
    if std is None:  # fan-in scaling
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return box((std * x).to(dtype), axes)


def zeros(shape, dtype: torch.dtype, device, axes=None) -> torch.Tensor:
    return box(torch.zeros(tuple(shape), dtype=dtype, device=device), axes)


def ones(shape, dtype: torch.dtype, device, axes=None) -> torch.Tensor:
    return box(torch.ones(tuple(shape), dtype=dtype, device=device), axes)


def constant(val, shape, dtype: torch.dtype, device,
             axes=None) -> torch.Tensor:
    return box(torch.full(tuple(shape), val, dtype=dtype, device=device),
               axes)


# --- trees: nested dicts (keys visited in sorted order), lists and nodes ---

def is_node(x) -> bool:
    """A tree node of its own kind: an object whose class defines
    ``tree_flatten() -> (children, aux)`` and the classmethod
    ``tree_unflatten(aux, children)``, as a registered JAX pytree class does
    (``nn.lora.LoraPair``: children ``(a, b)``, ``alpha`` static)."""
    return hasattr(type(x), "tree_unflatten") and hasattr(x, "tree_flatten")


def tree_flatten(tree):
    """(leaves, treedef) of a nested dict/list/tuple/node tree of leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves += lv
            defs.append(d)
        return leaves, ("dict", keys, defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            lv, d = tree_flatten(x)
            leaves += lv
            defs.append(d)
        return leaves, (type(tree).__name__, None, defs)
    if is_node(tree):
        children, aux = tree.tree_flatten()
        leaves, defs = [], []
        for x in children:
            lv, d = tree_flatten(x)
            leaves += lv
            defs.append(d)
        return leaves, ("node", (type(tree), aux), defs)
    return [tree], None


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, defs = d
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in zip(keys, defs)}
    items = [_build(sub, it) for sub in defs]
    if kind == "node":
        cls, aux = keys
        return cls.tree_unflatten(aux, items)
    return items if kind == "list" else tuple(items)


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`. A module-level recursion: a nested
    function that calls itself is a reference cycle, which would keep the
    ``leaves`` iterator (and every leaf tensor) alive until the cyclic
    garbage collector happens to run."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_paths(tree, prefix=()):
    """The key path of each leaf, in :func:`tree_leaves` order: a tuple of
    dict keys and list indices (a node's children by position)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree)
                for p in tree_paths(x, prefix + (i,))]
    if is_node(tree):
        children, _ = tree.tree_flatten()
        return [p for i, x in enumerate(children)
                for p in tree_paths(x, prefix + (i,))]
    return [prefix]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def count_params(tree) -> int:
    """Elements over every leaf of a parameter tree."""
    return sum(x.numel() for x in tree_leaves(tree))


def axes_of(tree):
    """The logical-axes tree of a parameter tree (tuples as leaves, the
    tree's structure otherwise): what :func:`box` stamped on each leaf.
    Raises for a leaf with none, naming its path."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for path, x in zip(tree_paths(tree), leaves):
        axes = getattr(x, AXES_ATTR, None)
        if axes is None:
            raise ValueError(
                f"parameter {'/'.join(map(str, path))} carries no logical "
                f"axes (made outside an initializer, or converted); use "
                f"param_axes(init, cfg) to rebuild them")
        out.append(axes)
    return tree_unflatten(treedef, out)


def param_axes(init, cfg):
    """The axes tree of ``init(cfg, generator, device="meta")``: a family's
    initializer run on ``meta``, nothing allocated."""
    return axes_of(init(cfg, torch.Generator(), device="meta"))


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def axes_leaves(axes_tree):
    """The leaves of an axes tree in :func:`tree_leaves` order (each a
    tuple, which :func:`tree_flatten` would walk into)."""
    if is_axes(axes_tree):
        return [axes_tree]
    if isinstance(axes_tree, dict):
        return [a for k in sorted(axes_tree)
                for a in axes_leaves(axes_tree[k])]
    if isinstance(axes_tree, (list, tuple)):
        return [a for x in axes_tree for a in axes_leaves(x)]
    if is_node(axes_tree):
        return [a for x in axes_tree.tree_flatten()[0]
                for a in axes_leaves(x)]
    raise TypeError(f"not an axes tree: {axes_tree!r}")
