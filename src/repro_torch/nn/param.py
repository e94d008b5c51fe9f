"""Parameters: initializers, the device rule, and tree helpers.

Port of ``src/repro/nn/param.py``. The reference boxes every leaf with its
logical sharding axes (``Boxed``) for the TPU mesh; the port has no mesh
yet, so a parameter tree is a plain nested dict (and list) of tensors and
the axes are dropped. The one node of another kind is a LoRA site's
``nn.lora.LoraPair`` (:func:`is_node`), which the tree helpers walk as the
reference's pytree registration makes JAX walk it. Initializers draw from
an explicit ``torch.Generator`` on an explicit device, with the
reference's distributions (fan-in std for matrices unless given).
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


def pad_to(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]


def normal(gen: torch.Generator, shape, dtype: torch.dtype, device,
           std: Optional[float] = None) -> torch.Tensor:
    if std is None:  # fan-in scaling
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return (std * x).to(dtype)


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


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
