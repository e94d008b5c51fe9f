"""Logical-axis sharding rules and mesh construction (DESIGN.md §4).

Port of ``src/repro/dist/sharding.py`` onto ``torch.distributed``. Model
code names *logical* axes ("batch", "mlp", ...); how those map onto mesh
axes is a per-run decision carried by a rules dict inside a ``use_rules``
context:

    with use_rules(mesh, {"batch": ("data",), "mlp": "model"}):
        sh = sharding_tree(axes_tree)     # Replicate()/Shard(d) placements

Outside any context every helper degrades to the identity. Rule values may
be ``None`` (replicate), a mesh-axis name, or a tuple of mesh-axis names
(``("pod", "data")`` for multi-pod data parallelism). A logical axis absent
from the rules replicates.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the initialized world, one process per rank
(:func:`make_mesh`, :func:`make_mesh_over`). ``spec`` returns a plain tuple
of resolved mesh axes where the reference returns a ``PartitionSpec``.

``shard`` is the identity without an active mesh, as in the reference. The
port's model code does not call it (``core/taps.py``): the mesh path is
data-parallel only (``dist.pex``), and only the compile dry-run enters
rules with a mesh, so an activation constraint under a mesh rule raises
until that dry-run is ported (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import (Any, Dict, Iterator, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

AxisRule = Union[None, str, Tuple[str, ...]]


def pad_to(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple


# --- rules context ---------------------------------------------------------

class _RulesStack(threading.local):
    def __init__(self):
        self.stack = []


_ACTIVE = _RulesStack()


@contextmanager
def use_rules(mesh, rules: Dict[str, AxisRule]) -> Iterator[None]:
    """Activate a (mesh, logical→mesh rules) pair for the dynamic extent.

    ``mesh=None`` keeps ``shard`` an identity while still letting ``spec``
    resolve rules. Contexts nest; the innermost wins.
    """
    _ACTIVE.stack.append((mesh, dict(rules)))
    try:
        yield
    finally:
        _ACTIVE.stack.pop()


def current_rules() -> Tuple[Any, Dict[str, AxisRule]]:
    """(mesh, rules) of the innermost active context, or (None, {})."""
    if _ACTIVE.stack:
        return _ACTIVE.stack[-1]
    return None, {}


def active_mesh():
    return current_rules()[0]


# --- specs -----------------------------------------------------------------

def _resolve(rule: AxisRule) -> AxisRule:
    if isinstance(rule, (list, tuple)):
        flat = tuple(a for a in rule if a is not None)
        if not flat:
            return None
        return flat if len(flat) > 1 else flat[0]
    return rule


def spec(*axes: Optional[str]) -> Tuple[AxisRule, ...]:
    """Logical axis names (None ⇒ replicated dim) → one resolved mesh-axis
    entry per dim (None, a mesh-axis name or a tuple of them).

    Names missing from the active rules replicate — new model code can
    introduce logical axes before every launch config maps them.
    """
    _, rules = current_rules()
    return tuple(None if ax is None else _resolve(rules.get(ax))
                 for ax in axes)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to the active mesh along logical ``axes``.

    Identity (returns ``x`` itself) when no mesh is active or no axis
    resolves to a mesh axis. An activation constraint under a mesh rule
    belongs to the compile dry-run, which the port does not have yet."""
    mesh = active_mesh()
    if mesh is None or all(a is None for a in spec(*axes)):
        return x
    raise NotImplementedError(
        f"shard(..., {axes}) under mesh rules {spec(*axes)}: activation "
        f"sharding constraints belong to the compile dry-run, which the "
        f"port does not have yet (ROADMAP.md Queue 1 item 12); the port's "
        f"mesh path is data-parallel only (dist.pex)")


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: one ``torch.distributed.tensor``
    placement per mesh dimension (the reference's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def sharding_for(axes: Sequence[Optional[str]], mesh=None) -> Sharding:
    """Placements for one logical-axes tuple: mesh dimension m is
    ``Shard(d)`` when tensor dim d's logical axis resolves to (or through)
    mesh axis m, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise RuntimeError("sharding_for requires a mesh "
                           "(pass one or enter use_rules(mesh, ...))")
    names = mesh.mesh_dim_names
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec(*axes)):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            placements[names.index(a)] = Shard(d)
    return Sharding(mesh, tuple(placements))


def sharding_tree(axes_tree: Any, mesh=None) -> Any:
    """Map a tree (dicts and lists) of logical-axes tuples to
    :class:`Sharding` s under the active rules."""
    if isinstance(axes_tree, dict):
        return {k: sharding_tree(v, mesh) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [sharding_tree(v, mesh) for v in axes_tree]
    return sharding_for(axes_tree, mesh)


# --- mesh construction -----------------------------------------------------

def make_mesh_over(ranks: Sequence[int], shape: Sequence[int],
                   axes: Sequence[str], *, device_type: str = "cuda"):
    """Mesh over an *explicit* rank subset — the elastic
    contraction/expansion primitive: after a host loss the surviving ranks
    (in renumbered order) become the new data axis. ``len(ranks)`` must
    equal ``prod(shape)``. Every rank of the world calls it (the mesh's
    process groups are made collectively); a rank outside ``ranks`` gets a
    mesh it is not in."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks cannot fill a mesh of "
                         f"shape {tuple(shape)} (= {n})")
    return DeviceMesh(device_type,
                      torch.tensor(list(ranks), dtype=torch.int).reshape(
                          tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """Mesh of ``shape`` over every rank of the initialized world, in rank
    order. ``device_type`` is ``"cuda"`` unless the caller asks for
    ``"cpu"``."""
    import torch.distributed as dist

    return make_mesh_over(range(dist.get_world_size()), shape, axes,
                          device_type=device_type)


# --- mesh arithmetic -------------------------------------------------------

def axis_size(axes: AxisRule, mesh=None) -> int:
    """Product of mesh extents over ``axes`` (str | tuple | None)."""
    mesh = mesh if mesh is not None else active_mesh()
    if axes is None or mesh is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    extent = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n = 1
    for a in axes:
        if a is not None:
            n *= extent[a]
    return n


def local_batch(global_batch: int, data_axes: AxisRule, mesh=None) -> int:
    """Per-shard batch under data parallelism; must divide evenly (the data
    pipeline pads with ``pad_to`` before it ever reaches a mesh)."""
    n = axis_size(data_axes, mesh)
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by the "
            f"{n}-way data-parallel extent {data_axes!r}; pad with "
            f"pad_to({global_batch}, {n}) upstream")
    return global_batch // n
