"""Data-parallel per-example-norm pipeline on ``torch.distributed``
(DESIGN.md §4).

Port of ``src/repro/dist/pex.py``. The reference lifts the ``core`` passes
onto a device mesh with ``shard_map``; the port runs one process per rank,
each holding every parameter, and keeps ``shard_map``'s contract with
``P(data_axes)``: **global arrays in, global arrays out**.

  * Every rank receives the same global batch and takes its contiguous
    block of rows: rank r of n along the data axes takes rows
    ``[r·B/n, (r+1)·B/n)``, ``P("data")``'s layout (several data axes, as
    ``("pod", "data")``, flatten in their order, the first outermost).
  * Each rank runs the fused plan core (``plan.run_fused``) on its rows.
  * The summed gradients cross ranks in one ``all_reduce(SUM)`` per leaf,
    in the tree's order and the leaf's own dtype, over the process group
    of the data axes' product.
  * The per-example outputs — losses, norms, weights, clip coefficients —
    come back as global (B,) / (B, G) / (B, S) tensors on every rank: each
    rank writes its rows into a zero-filled global buffer, which is
    all-reduced. Adding zeros is exact, so every rank holds the same bits
    (gloo gathers no CUDA tensor; an all-reduce it does).

Clipping composes for free: c_j depends only on example j's own norm, so
it is computed rank-locally and the clipped gradients reduce like plain
ones. DP-SGD noise is added once, *after* the reduce, by ``plan.execute``'s
driver; every rank draws it from a generator with the same seed, so the
replicated gradients stay bit-identical across ranks. GNS and the
importance sample act on the global arrays between regions
(``plan.execute(fused_fn=)``); the sub-batch is gathered from the global
batch and re-sharded, so the pool and ``k`` must both divide by the shard
count (``sharding.local_batch`` raises otherwise).

Data parallelism is the only kind: a mesh axis outside ``data_axes`` with
extent > 1 is rejected, as in the reference.

The loss these functions take is the plan layer's explicit-accumulator
form ``acc_loss(params, acc, batch) -> (loss_vec, token_map | None, tap,
aux)`` (``Engine`` builds one from a tap-collector loss).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import plan as plan_mod
from repro_torch.core.passes import PexResult, check_noise_args
from repro_torch.core.taps import ExampleLayout, PexSpec, TokenLayout
from repro_torch.dist import sharding as shd
from repro_torch.nn.param import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)

DataAxes = Tuple[str, ...]


def _norm_axes(data_axes) -> DataAxes:
    if isinstance(data_axes, str):
        return (data_axes,)
    return tuple(data_axes)


def _reject_aux(aux) -> None:
    """The mesh path returns ``aux == {}``: an arbitrary aux tree has no
    known layout (per-example? replicated?). Fail loudly instead of
    silently dropping real metrics."""
    if any(x is not None for x in tree_leaves(aux)):
        raise NotImplementedError(
            "loss_fn returned a non-empty aux tree, which the data-parallel "
            "per-example pipeline does not thread through; fold metrics "
            "into loss_vec/sq_norms or run on one process (mesh=None)")


def _reject_model_axes(mesh, data_axes: DataAxes) -> None:
    extent = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    missing = [a for a in data_axes if a not in extent]
    if missing:
        raise ValueError(f"data_axes {missing} are not axes of the mesh "
                         f"{tuple(extent)}")
    big_rest = [a for a, n in extent.items()
                if a not in data_axes and n > 1]
    if big_rest:
        raise NotImplementedError(
            f"mesh axes {big_rest} (extent > 1) outside data_axes="
            f"{data_axes}: the per-example pipeline is data-parallel only, "
            f"as the reference's; run it data-parallel-only, or include "
            f"the axis in data_axes")


class DataShards(NamedTuple):
    """This rank's place along a mesh's data axes."""
    group: Any      # process group over the data axes' product
    index: int      # this rank's shard, data axes flattened in order
    count: int      # the number of shards


#: id(mesh) → {data_axes: process group}: a product group is made once per
#: mesh object (keyed by identity: an equal mesh of a later world must not
#: reuse a destroyed group) and forgotten with it
_PRODUCT_GROUPS: dict = {}


def _product_group(mesh, data_axes: DataAxes, ranks: list):
    groups = _PRODUCT_GROUPS.get(id(mesh))
    if groups is None:
        groups = _PRODUCT_GROUPS[id(mesh)] = {}
        weakref.finalize(mesh, _PRODUCT_GROUPS.pop, id(mesh), None)
    if data_axes not in groups:
        groups[data_axes] = dist.new_group(ranks,
                                           use_local_synchronization=True)
    return groups[data_axes]


def data_shards(mesh, data_axes: Sequence[str] = ("data",)) -> DataShards:
    """The process group, shard index and shard count of ``data_axes`` on
    ``mesh`` for this rank. One data axis uses the mesh's own group; the
    group of several is made (by its members only) on first use."""
    data_axes = _norm_axes(data_axes)
    _reject_model_axes(mesh, data_axes)
    names = list(mesh.mesh_dim_names)
    if len(data_axes) == 1:
        a = data_axes[0]
        return DataShards(mesh.get_group(a), mesh.get_local_rank(a),
                          mesh.size(names.index(a)))
    dims = [names.index(a) for a in data_axes]
    rest = [d for d in range(len(names)) if d not in dims]
    count = shd.axis_size(data_axes, mesh)
    rows = mesh.mesh.permute(rest + dims).reshape(-1, count).tolist()
    me = dist.get_rank()
    row = next(r for r in rows if me in r)
    return DataShards(_product_group(mesh, data_axes, row), row.index(me),
                      count)


# --- the collectives -------------------------------------------------------

def _rows(tree, lo: int, n: int):
    """Rows [lo, lo + n) of every tensor leaf with a leading axis."""
    return tree_map(lambda x: x.narrow(0, lo, n)
                    if isinstance(x, torch.Tensor) and x.ndim else x, tree)


def _gather_rows(x: torch.Tensor, shards: DataShards) -> torch.Tensor:
    """This rank's rows of a per-example tensor → the global tensor on
    every rank: the rows written into a zero-filled buffer, all-reduced."""
    n = x.shape[0]
    full = x.new_zeros((shards.count * n,) + tuple(x.shape[1:]))
    full.narrow(0, shards.index * n, n).copy_(x)
    dist.all_reduce(full, group=shards.group)
    return full


def _reduce_grads(grads, shards: DataShards):
    """Σ over the data shards of every gradient leaf, one all-reduce per
    leaf, in the tree's order and the leaf's dtype."""
    leaves, treedef = tree_flatten(grads)
    out = []
    for g in leaves:
        g = g.contiguous()
        dist.all_reduce(g, group=shards.group)
        out.append(g)
    return tree_unflatten(treedef, out)


def check_replicated(tree, mesh, data_axes: Sequence[str] = ("data",),
                     what: str = "parameters") -> None:
    """Raise on every rank unless every data shard holds the bits of the
    first one's ``tree`` (one broadcast per leaf from that rank)."""
    shards = data_shards(mesh, data_axes)
    leaves = tree_leaves(tree)
    if not leaves:
        return
    src = dist.get_global_rank(shards.group, 0)
    differ = 0
    for x in leaves:
        got = x.detach().clone()
        dist.broadcast(got, src=src, group=shards.group)
        differ |= int(not torch.equal(got, x))
        del got
    flag = torch.tensor([differ], device=leaves[0].device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=shards.group)
    if flag.item():
        raise ValueError(
            f"the {what} differ across the {shards.count} data-parallel "
            f"ranks; build them from the same seed on every rank")


# --- consumer plans (DESIGN.md §9) -----------------------------------------

def plan_step(plan, acc_loss: Callable, params, batch, batch_size: int, *,
              mesh, data_axes: Sequence[str] = ("data",), layout=None,
              loss_weights=None) -> plan_mod.StepResult:
    """Run a fused consumer plan data-parallel over ``mesh``.

    The single-region core (``plan.run_fused``) runs on each rank's rows;
    per-example losses, norms and weights come back global, gradients
    cross ranks in one all-reduce, and DP-SGD noise / GNS are applied by
    the shared driver *after* the region — noise once on the reduced
    gradient, GNS on the global arrays. ``Importance`` plans run two
    regions (norms on the pool, reweighted gradients on the gathered
    sub-batch) with the sample and the gather on the global arrays between
    them. ``mesh=None`` runs on this process alone."""
    if mesh is None:
        return plan_mod.execute(plan, acc_loss, params, batch, batch_size,
                                layout, loss_weights=loss_weights)
    data_axes = _norm_axes(data_axes)
    shards = data_shards(mesh, data_axes)

    def fused_fn(sub, b, bs, lw):
        local_b = shd.local_batch(bs, data_axes, mesh)
        lo = shards.index * local_b
        lv, aux, sq, grads, w, _, cc = plan_mod.run_fused(
            sub, acc_loss, params, _rows(b, lo, local_b), local_b, layout,
            loss_weights=None if lw is None else lw.narrow(0, lo, local_b))
        _reject_aux(aux)
        lv = _gather_rows(lv, shards)
        sq = None if sq is None else _gather_rows(sq, shards)
        # an example clip's w IS its clip coefficients: gather once
        cc_g = None if cc is None else _gather_rows(cc, shards)
        w = cc_g if w is not None and w is cc else \
            (None if w is None else _gather_rows(w, shards))
        tw = cc_g if sub.token_weighted else None
        grads = None if grads is None else _reduce_grads(grads, shards)
        return lv, {}, sq, grads, w, tw, cc_g

    return plan_mod.execute(plan, acc_loss, params, batch, batch_size,
                            layout, loss_weights=loss_weights,
                            fused_fn=fused_fn)


def _passes(plan, acc_loss, params, batch, spec: PexSpec, batch_size: int,
            mesh, data_axes, layout) -> PexResult:
    layout = layout if layout is not None else ExampleLayout(spec.n_groups)
    r = plan_step(plan, acc_loss, params, batch, batch_size, mesh=mesh,
                  data_axes=data_axes, layout=layout)
    return PexResult(r.loss, r.loss_vec, r.aux, r.sq_norms, r.grads)


def value_and_norms(acc_loss: Callable, params, batch, spec: PexSpec,
                    batch_size: int, *, mesh=None,
                    data_axes: Sequence[str] = ("data",),
                    layout=None) -> PexResult:
    """Norms-only pass; the loss is the global scalar, ``loss_vec`` and
    ``sq_norms`` the global (B,) / (B, G) tensors on every rank. ``aux``
    is {} on the mesh path (a non-empty aux raises); the variants below
    share this contract. ``mesh=None`` runs on this process alone."""
    return _passes(plan_mod.analyze([plan_mod.Norms()]), acc_loss, params,
                   batch, spec, batch_size, mesh, data_axes, layout)


def value_grads_and_norms(acc_loss: Callable, params, batch, spec: PexSpec,
                          batch_size: int, *, mesh=None,
                          data_axes: Sequence[str] = ("data",),
                          layout=None) -> PexResult:
    """Summed gradients (all-reduced over the data axes) AND the global
    per-example norms from one backward per rank."""
    return _passes(plan_mod.analyze([plan_mod.Norms(), plan_mod.Grads()]),
                   acc_loss, params, batch, spec, batch_size, mesh,
                   data_axes, layout)


def clipped_value_and_grads(acc_loss: Callable, params, batch,
                            spec: PexSpec, batch_size: int, clip_norm: float,
                            noise_std: float = 0.0,
                            noise_rng: Optional[torch.Generator] = None, *,
                            mesh=None, data_axes: Sequence[str] = ("data",),
                            layout=None) -> PexResult:
    """Per-example (per-token under a ``TokenLayout``) clipping, two-pass
    ghost form (paper §6), both passes rank-local, one gradient reduce at
    the end; σ·C noise from ``noise_rng`` added once to the reduced
    gradient (every rank's generator seeded alike)."""
    check_noise_args(noise_std, noise_rng)
    token = isinstance(layout, TokenLayout)
    cons = [plan_mod.Clip(clip_norm,
                          granularity="token" if token else "example")]
    if noise_std > 0.0:
        cons.append(plan_mod.Noise(noise_std, noise_rng, scale=clip_norm))
    return _passes(plan_mod.analyze(cons, engine_granularity="token"
                                    if token else "example"),
                   acc_loss, params, batch, spec, batch_size, mesh,
                   data_axes, layout)


# --- diagnostics -----------------------------------------------------------

def gradient_noise_scale(sq_norms: torch.Tensor, grads,
                         batch_size: Optional[int] = None) -> torch.Tensor:
    """B_simple = tr(Σ) / ||G||² — see ``core.plan.gradient_noise_scale``
    (this re-export keeps the dist-level entry point)."""
    return plan_mod.gradient_noise_scale(sq_norms, grads,
                                         batch_size=batch_size)
