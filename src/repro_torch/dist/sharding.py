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

Model-axis sharding is ``torch.distributed.tensor`` (DTensor): under
``use_rules(mesh, rules)``, :func:`distribute_tree` lays a parameter tree
out by its logical axes (``nn.param.axes_of``), each leaf a DTensor whose
placements :func:`sharding_for` gives, and :func:`shard` is the activation
constraint: a DTensor is redistributed to the placements its logical axes
resolve to (the reference's ``with_sharding_constraint``); anything else,
and everything outside a mesh context, passes through as it is.
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
    """(mesh, rules) of this thread's innermost active context; in a
    thread with none, those that were active where the innermost
    :func:`sharded_step` began (a CUDA backward, and so a checkpointed
    block's recompute, runs on autograd's device thread and must lay its
    activations out as the forward did); else (None, {})."""
    if _ACTIVE.stack:
        return _ACTIVE.stack[-1]
    if _STEP:
        return _STEP[-1][2]
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


def inference(params):
    """The serving entry points' no-autograd context: inference mode, or
    for DTensor parameters ``no_grad`` (DTensor's in-place cache writes
    need the version counters inference tensors do not keep)."""
    from repro_torch.nn.param import tree_leaves
    if any(is_dtensor(x) for x in tree_leaves(params)):
        return torch.no_grad()
    return torch.inference_mode()


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``? (False without a
    DTensor-capable build, and for every plain tensor.)"""
    return type(x).__name__ == "DTensor" and hasattr(x, "placements")


def gathered(param, x):
    """A DTensor parameter as a layer uses it beside its input ``x``:
    gathered over the mesh dims on which ``x`` is sharded by examples
    (FSDP: the data axes shard a weight at rest, and its rows meet whole
    weights; the gradient is reduce-scattered back), as it is elsewhere.
    DTensor would otherwise bring the (larger) activations to the
    weight's feature shards. Anything else passes as it is."""
    if not (is_dtensor(param) and is_dtensor(x)):
        return param
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(px, Shard) and px.dim == 0
                 else pp for pp, px in zip(param.placements, x.placements))
    if want == tuple(param.placements):
        return param
    return param.redistribute(param.device_mesh, want)


def dense_layout(z, h, w):
    """``z = h @ w`` laid out as its operands say, where DTensor's own
    choice may differ (it shards an output wherever slicing a replicated
    operand is free): per mesh dim, the features where ``w``'s output
    features are sharded, the examples where ``h``'s are, else
    replicated (a partial sum over the contraction is all-reduced, as
    tensor parallelism's row-parallel layer does). Plain tensors pass."""
    if not is_dtensor(z):
        return z
    from torch.distributed.tensor import Replicate, Shard
    want = []
    for ph, pw in zip(h.placements if is_dtensor(h) else
                      (Replicate(),) * z.device_mesh.ndim, w.placements
                      if is_dtensor(w) else
                      (Replicate(),) * z.device_mesh.ndim):
        if isinstance(pw, Shard) and pw.dim % w.ndim == w.ndim - 1:
            want.append(Shard(z.ndim - 1))
        elif isinstance(ph, Shard) and ph.dim == 0:
            want.append(Shard(0))
        else:
            want.append(Replicate())
    if tuple(want) == tuple(z.placements):
        return z
    return z.redistribute(z.device_mesh, want)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to the active mesh along logical ``axes`` (one per
    dim of ``x``).

    A DTensor under an active mesh is redistributed to the placements the
    rules give its axes (no collective when it already has them; a
    ``Partial`` sum over a mesh axis the rules replicate is all-reduced,
    a shard they replicate is all-gathered). Identity (returns ``x``
    itself) for any other tensor, or when no mesh is active."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"shard: {len(axes)} logical axes {axes} for a "
                         f"{x.ndim}-d tensor of shape {tuple(x.shape)}")
    want = sharding_for(axes, x.device_mesh).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


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


def distribute_tree(params: Any, axes_tree: Any, mesh=None) -> Any:
    """``params`` laid out on the mesh by their logical axes under the
    active rules: each leaf a DTensor with :func:`sharding_for`'s
    placements, its local shard cut from the full leaf this process holds
    (every rank holds the same full tree, so no collective is sent).
    Leaves that are DTensors already are redistributed."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.nn.param import axes_leaves, tree_flatten, \
        tree_unflatten
    mesh = mesh if mesh is not None else active_mesh()
    leaves, treedef = tree_flatten(params)
    axes = axes_leaves(axes_tree)
    if len(axes) != len(leaves):
        raise ValueError(f"{len(axes)} axes leaves for {len(leaves)} "
                         f"parameters")
    out = []
    for x, ax in zip(leaves, axes):
        pl = sharding_for(ax, mesh).placements
        if is_dtensor(x):
            out.append(x.redistribute(mesh, pl))
        else:
            out.append(distribute_tensor(x, mesh, pl, src_data_rank=None))
    return tree_unflatten(treedef, out)


def sharding_tree(axes_tree: Any, mesh=None) -> Any:
    """Map a tree (dicts and lists) of logical-axes tuples to
    :class:`Sharding` s under the active rules."""
    if isinstance(axes_tree, dict):
        return {k: sharding_tree(v, mesh) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [sharding_tree(v, mesh) for v in axes_tree]
    return sharding_for(axes_tree, mesh)


# --- collectives of a gloo group on CUDA tensors ----------------------------

_HOST_STAGED = []


def stage_collectives_on_host() -> None:
    """Run the functional collectives DTensor sends (``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) on CUDA tensors through host copies: each is
    the same collective on a CPU copy of its input, waited for, its
    result copied back to the input's device. For a gloo group whose
    ranks share a card (NCCL takes one rank a card), whose functional
    collectives on CUDA tensors gloo does not carry; the compute stays on
    the card. Registered once a process."""
    if _HOST_STAGED:
        return
    ops = torch.ops._c10d_functional
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def staged(op):
        def run(x, *args):
            return ops.wait_tensor(op(x.cpu(), *args)).to(x.device)
        return run
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single"):
        lib.impl(name, staged(getattr(ops, name).default), "CUDA")
    _HOST_STAGED.append(lib)


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


# --- the sharded step: DTensor operands of the per-example stats -----------

#: the active sharded steps: process-wide, not per thread, since the
#: backward of a CUDA step runs on autograd's own device thread
_STEP = []


@contextmanager
def sharded_step(mesh, batch_dims: Sequence[int]) -> Iterator[None]:
    """The dynamic extent of one sharded ``Engine`` pass on ``mesh``: the
    accumulator of the per-example stats is a plain tensor of this rank's
    rows, sharded over the mesh dims ``batch_dims`` (those that shard the
    batch) and a partial sum over every other mesh dim
    (:func:`stat_to_acc`, :func:`reduce_acc`). Plain tensors meeting
    DTensors inside it are taken as replicated
    (``implicit_replication``). The rules active here stay the rules of
    every thread without its own (:func:`current_rules`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    _STEP.append((mesh, tuple(batch_dims), current_rules()))
    try:
        with implicit_replication():
            yield
    finally:
        _STEP.pop()


def current_step():
    """(mesh, batch mesh dims) of the innermost :func:`sharded_step`, or
    None outside one."""
    return _STEP[-1][:2] if _STEP else None


def batch_mesh_dims(mesh, rules: Optional[Dict[str, AxisRule]] = None):
    """The mesh dims the logical ``batch`` axis resolves to."""
    if rules is None:
        rules = current_rules()[1]
    entry = _resolve(rules.get("batch"))
    names = mesh.mesh_dim_names
    return tuple(names.index(a) for a in
                 ((entry,) if isinstance(entry, str) else (entry or ())))


def _canonical(p, ndim: int):
    """A placement as the stats read it: a ``Partial`` sum is reduced first
    (a norm of a partial sum is not a sum of norms), and so is a shard of
    a row dim between the example axis and the features (the rows of one
    example are contracted)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if isinstance(p, Partial):
        return Replicate()
    if isinstance(p, Shard):
        d = p.dim % ndim
        if 0 < d < ndim - 1:
            return Replicate()
        return Shard(d)
    return p


def local_operands(ops: Sequence[torch.Tensor], *,
                   elementwise: bool = False):
    """The local shards on which a per-example stat of ``ops`` (DTensors
    on one mesh, each (B, [rows...,] features)) is computed shard by
    shard, and the placements of the stat that comes out: per mesh dim,

      * ``Shard(0)`` where the example axis is sharded (every operand is
        brought to its rows: a replicated one is sliced, no collective);
      * ``Partial()`` where a feature dim is sharded: the shard's stat is
        the squared norm of its block of G = HᵀZ̄, and the blocks' norms
        add. Where both H's and Z̄'s features are sharded over one mesh
        dim their blocks would not pair up, so H (every operand but the
        last) is gathered first and Z̄ stays sharded. ``elementwise``
        operands (z = g ⊙ h) are sharded alike instead;
      * ``Replicate()`` otherwise.

    A ``Partial`` operand and a shard of a contracted row dim are reduced
    (gathered) first. (The expert buffers' (G, E, C, ·) stats have rules of
    their own: ``core.taps._expert_stat_sharded``.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ops[0].device_mesh
    n = len(mesh.mesh_dim_names)
    want = [list(x.placements) for x in ops]
    out = []
    for i in range(n):
        pl = [_canonical(x.placements[i], x.ndim) for x in ops]
        feat = [isinstance(p, Shard) and p.dim == x.ndim - 1
                for p, x in zip(pl, ops)]
        if any(isinstance(p, Shard) and p.dim == 0 for p in pl):
            pl = [Shard(0)] * len(ops)
            out.append(Shard(0))
        elif any(feat):
            if elementwise:
                pl = [Shard(x.ndim - 1) for x in ops]
            elif sum(feat) > 1:
                pl = [Replicate()] * (len(ops) - 1) + [pl[-1]]
            out.append(Partial())
        else:
            pl = [Replicate()] * len(ops)
            out.append(Replicate())
        for w, p in zip(want, pl):
            w[i] = p
    local = []
    for x, w in zip(ops, want):
        if tuple(w) != tuple(x.placements):
            x = x.redistribute(mesh, w)
        local.append(x.to_local())
    return local, tuple(out)


def wrap_stat(local: torch.Tensor, mesh, placements, rows):
    """A DTensor of per-row stats from this rank's ``local`` piece (its
    rows where ``Shard(0)``, its partial sum where ``Partial``): (rows,)
    for an int ``rows``, else of the whole shape ``rows``."""
    from torch.distributed.tensor import DTensor
    shape = (rows,) if isinstance(rows, int) else tuple(rows)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def reduce_factor(local: torch.Tensor, mesh, placements, shape):
    """This rank's piece of one factor of a per-token product, summed over
    the mesh dims where ``placements`` is ``Partial`` (an all-reduce of the
    small stat map), and its placements after: the product of two partial
    sums is not the partial sum of the product, so each factor is whole
    over the dims that shard its own features before the multiply."""
    from torch.distributed.tensor import Partial, Replicate
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in placements)
    if pl == tuple(placements):
        return local, pl
    return wrap_stat(local, mesh, placements, shape).redistribute(
        mesh, pl).to_local(), pl


def token_stat(ops: Sequence[torch.Tensor], rowsumsq, *,
               elementwise: bool = False):
    """A per-token stat of DTensor operands (each (B, S, [rows...,]
    features)) as a (B, S) DTensor, from this rank's local shards:
    ``rowsumsq(x)`` is the local Σx² over every axis past the first two
    (the ``rowsumsq`` kernel on a CUDA shard). The factor rule, per mesh
    dim:

      * the examples sharded by any operand: every operand at its rows
        (``Shard(0)``);
      * a feature dim sharded: one operand's Σx² (the bias and embedding
        taps, z̄) and the elementwise Σ(h ⊙ z̄)² (the scale tap, both
        brought to the same feature shards) are partial sums over the dim
        and stay ``Partial``, as the example route's stats do; the dense
        product ‖h_t‖²·‖z̄_t‖² of two operands has each factor summed over
        the dims that shard its own features first (:func:`reduce_factor`),
        so the product is whole there (``Replicate``);
      * otherwise replicated.

    A ``Partial`` operand and a shard of a row dim past the tokens are
    reduced (gathered) first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ops[0].device_mesh
    shape = tuple(ops[0].shape[:2])
    want = [list(x.placements) for x in ops]
    for i in range(mesh.ndim):
        pl = [_canonical(x.placements[i], x.ndim) for x in ops]
        feat = [isinstance(p, Shard) and p.dim == x.ndim - 1
                for p, x in zip(pl, ops)]
        if any(isinstance(p, Shard) and p.dim == 0 for p in pl):
            pl = [Shard(0)] * len(ops)
        elif elementwise and any(feat):
            pl = [Shard(x.ndim - 1) for x in ops]
        else:
            pl = [p if f else Replicate() for p, f in zip(pl, feat)]
        for w, p in zip(want, pl):
            w[i] = p
    local = []
    for x, w in zip(ops, want):
        if tuple(w) != tuple(x.placements):
            x = x.redistribute(mesh, w)
        local.append(x.to_local())
    # the stat map's placements of one operand's local Σx²
    maps = [tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
                  Partial() if isinstance(p, Shard) else Replicate()
                  for p in w) for w in want]
    if elementwise:
        prod = local[0].to(torch.float32) * local[1].to(torch.float32)
        return wrap_stat(rowsumsq(prod), mesh, maps[0], shape)
    if len(ops) == 1:
        return wrap_stat(rowsumsq(local[0]), mesh, maps[0], shape)
    (a, pl), (b, _) = (reduce_factor(rowsumsq(x), mesh, m, shape)
                       for x, m in zip(local, maps))
    return wrap_stat(a * b, mesh, pl, shape)


def stat_to_acc(stat) -> torch.Tensor:
    """A stat DTensor (rows over the example axis) as this rank's piece of
    the step's accumulator (:func:`sharded_step`): its rows where a batch
    mesh dim shards them, and over every other mesh dim a partial sum —
    a ``Partial`` stat as it is, a replicated one kept on the dim's first
    coordinate and zero on the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, batch_dims = current_step()
    want, zero = [], False
    coord = mesh.get_coordinate()
    for i, p in enumerate(stat.placements):
        if i in batch_dims:
            want.append(Shard(0))
        elif isinstance(p, Partial):
            want.append(p)
        else:
            want.append(Replicate())
            zero = zero or coord[i] != 0
    if tuple(want) != tuple(stat.placements):
        stat = stat.redistribute(mesh, want)
    local = stat.to_local()
    return torch.zeros_like(local) if zero else local


def reduce_acc(acc: torch.Tensor) -> torch.Tensor:
    """The whole (B, ...) stat map on every rank from this rank's
    accumulator piece: summed over the partial mesh dims, gathered over
    the batch dims."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh, batch_dims = current_step()
    pl = [Shard(0) if i in batch_dims else Partial()
          for i in range(len(mesh.mesh_dim_names))]
    rows = acc.shape[0] * axis_size(tuple(mesh.mesh_dim_names[i]
                                          for i in batch_dims), mesh)
    return DTensor.from_local(acc, mesh, pl, run_check=False,
                              shape=(rows,) + tuple(acc.shape[1:]),
                              stride=acc.contiguous().stride()
                              ).full_tensor()


def like(ref, x: torch.Tensor):
    """Plain ``x`` (the whole tensor, the same on every rank) laid out as
    the DTensor ``ref``: each rank keeps its own piece, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def on_rows(fn, rows: Sequence[torch.Tensor],
            shared: Sequence[torch.Tensor] = ()):
    """``fn(*rows, *shared)`` on this rank's rows, for math that is
    shard-local over the examples (a recurrence per example): the
    DTensor ``rows`` (B, ...) are brought to their rows (``Shard(0)``
    where the first one shards the examples, whole elsewhere) and
    unwrapped, the ``shared`` operands replicated (their gradient comes
    back as a ``Partial`` sum over the example shards), and ``fn``'s
    output (B, ...) is wrapped back with the rows' placements. Plain
    operands run ``fn`` as they are."""
    if not any(is_dtensor(x) for x in list(rows) + list(shared)):
        return fn(*rows, *shared)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    first = next(x for x in rows if is_dtensor(x))
    mesh = first.device_mesh
    by_rows = [isinstance(_canonical(p, first.ndim), Shard)
               and _canonical(p, first.ndim).dim == 0
               for p in first.placements]
    pl = [Shard(0) if r else Replicate() for r in by_rows]
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if r else Replicate() for r in by_rows]

    def local(x, want, grad_pl):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, rep, run_check=False)
        return x.redistribute(mesh, want).to_local(grad_placements=grad_pl)
    out = fn(*[local(x, pl, pl) for x in rows],
             *[local(x, rep, grad) for x in shared])
    b = first.shape[0]
    shape = (b,) + tuple(out.shape[1:])
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def on_heads(fn, q, k, v):
    """``fn(q, k, v)`` — attention over q (B, S, H, D) and k, v (B, T,
    Hkv, D) to (B, S, H·Dv) — on this rank's examples and heads: per
    mesh dim, the three are brought to the examples where q's are
    sharded, to q's heads where those are (k and v to theirs where they
    divide alike, else each KV head repeated for its query heads and the
    rank's slice taken, their gradient then a ``Partial`` sum), and
    replicated otherwise; ``fn`` runs on the local tensors, and its
    output is laid out as q's examples and heads (a rank's heads are a
    contiguous slice of H·Dv). DTensor has no rule for the head-grouped
    products on every PyTorch release, and attention is local to an
    example and a head. Plain operands run ``fn`` as they are."""
    if not any(is_dtensor(x) for x in (q, k, v)):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    rep = q.shape[2] // k.shape[2]
    coord = mesh.get_coordinate()
    q_pl, kv_pl, kv_grad, out_pl, expand = [], [], [], [], None
    for i, p in enumerate(q.placements):
        p = _canonical(p, q.ndim) if not (isinstance(p, Shard)
                                          and p.dim % q.ndim == 2) else p
        pk = k.placements[i] if is_dtensor(k) else Replicate()
        if isinstance(p, Shard) and p.dim == 0:
            q_pl.append(Shard(0)), kv_pl.append(Shard(0))
            kv_grad.append(Shard(0)), out_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim % q.ndim == 2:
            q_pl.append(Shard(2)), out_pl.append(Shard(2))
            if isinstance(pk, Shard) and pk.dim % k.ndim == 2:
                kv_pl.append(Shard(2)), kv_grad.append(Shard(2))
            else:
                kv_pl.append(Replicate()), kv_grad.append(Partial())
                expand = (i, mesh.size(i))
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            kv_grad.append(Replicate()), out_pl.append(Replicate())

    def local(x, pl, grad):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, pl).to_local(grad_placements=grad)
    ql = local(q, q_pl, q_pl)
    kl, vl = (local(x, kv_pl, kv_grad) for x in (k, v))
    if expand is not None:
        i, m = expand
        kl, vl = (x.repeat_interleave(rep, dim=2).chunk(m, dim=2)[coord[i]]
                  for x in (kl, vl))
    out = fn(ql, kl, vl)
    shape = (q.shape[0], q.shape[1], out.shape[-1] * q.shape[2]
             // ql.shape[2])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=(shape[1] * shape[2],
                                                   shape[2], 1))


def distribute_batch(batch: Any, mesh) -> Any:
    """Each plain leaf of a batch tree laid out by ("batch", None, ...)
    under the active rules (every rank holds the whole batch); DTensor
    leaves stay as they are."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.nn.param import tree_map

    def one(x):
        if is_dtensor(x) or not isinstance(x, torch.Tensor):
            return x
        pl = sharding_for(("batch",) + (None,) * (x.ndim - 1),
                          mesh).placements
        return distribute_tensor(x, mesh, pl, src_data_rank=None)
    return tree_map(one, batch)
