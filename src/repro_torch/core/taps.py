"""Cotangent-accumulator taps — the paper's mechanism, in PyTorch autograd.

Port of ``src/repro/core/taps.py``. Backprop already computes, for every
dense layer, the pair ``(H, Z̄)`` from which per-example gradient norms
follow. Each instrumented op here is a ``torch.autograd.Function`` taking
``(h, w, acc)`` and returning ``(z, acc_out)``; its backward returns the
standard ``dh`` and ``dW`` *and* ``acc_bar + scatter(stat)``, the layer's
per-example stat added to the cotangent of an accumulator threaded through
the forward pass (the ``(z, acc)`` trick of the reference's custom_vjps).
``torch.autograd.grad`` w.r.t. the initial accumulator then recovers
``Σ_i s⁽ⁱ⁾`` in the same backward pass that yields the parameter gradients.

Backward mode (what JAX's dead-code elimination did for the reference): in
PyTorch every output an op's backward returns is computed, and
``ctx.needs_input_grad`` is fixed when the forward runs. So a live ``Tap``
carries a :class:`BackwardMode` that the plan layer sets before each
``torch.autograd.grad`` call and every op's backward reads: a norms-only
backward forms no ``dW``, and a gradient-only (reweighted) backward computes
no stat and launches no norm kernel.

Layers call ``z = tap.dense(h, w, group="mlp")`` and never see the
accumulator. A tap with ``spec.enabled=False`` or no accumulator is inert:
every op is its plain counterpart (``NULL`` is the shared inert tap).

Two accumulator layouts: ``ExampleLayout`` (B, n_groups), per-example
norms; ``TokenLayout`` (B, S), per-token norms, where every stat is a
row-wise Σx² (``kernels.ops.rowsumsq`` under ``PexSpec.use_kernels``, the
plain ``_sumsq_tail`` without it). The MoE expert ops (``dense_expert``,
``dense_expert_grouped``) take their example stat from the segmented
estimator over (group, expert, example) composite segments, all groups in
one launch, and their token stat per capacity slot, scattered to the
slot's token through the dispatch's slot → token table ``tok``.

``dense_batched`` is the per-example-weight matmul of the multi-tenant
LoRA form (example j multiplies its tenant's gathered adapter factor): its
example stat is the exact factorized one for (B, p) rows and, for (B, S, p)
rows, the segmented estimator over example-id segments, every example (and
so every tenant) in one launch; its token stat is the factorized one per
token, as for ``dense``.

Tap-site provenance (``PEX_OPS``): each tapped ``autograd.Function`` maps
to its op name and the slots of its weight and data operands; inside an
analysis trace (``analysis._trace``) every tapped call is recorded as one
site with its operands, which the coverage pass reads. Outside a trace the
table is not consulted.

Rematerialization (:func:`checkpoint`, the reference's ``taps.checkpoint``;
its ``taps.scan`` has no counterpart, as the port's layers run in a Python
loop): the block runs once in the forward with every tensor autograd would
save replaced by a handle (saved-tensor hooks), so the forward's graph — and
its Tap nodes, which read the :class:`BackwardMode` when each backward runs
— is the real one; the first handle a backward unpacks re-runs the block
from its inputs, once per backward, and stops as soon as the last tensor the
forward saved has been made again (the block's dead tail, e.g. its last
product, is not recomputed). The recompute runs on a copy of the tap as
it was at the block's entry (every slot, the accumulator a new leaf), so
``tap.carry()`` never moves mid-backward; a block takes its live tap as an
argument and does not close over it. Policy ``"full"`` keeps
only the block's inputs; ``"dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) also keeps every product with a 2-D
weight (``Tap.dense`` and :func:`matmul`), which the recompute then reads
instead of multiplying again; attention scores, ``dense_batched`` and the
expert products are recomputed.
The accumulators' ``init`` carries the reference's ``shard(...,
"batch", None)`` constraint; the accumulator is a plain tensor, on which
it is the identity.

Sharded operands (the model-axis route): under a ``dist.sharding``
``sharded_step`` the layers' operands are DTensors and the ops above run
on them as they are — the forward and the ``dh``/``dW`` products through
DTensor's own sharding rules, ``dW`` then laid out as its parameter by the
plan layer. Only the stats unwrap: ``core.norms`` computes each from the
rank's local shards (the kernels on local shards) and returns a DTensor,
which ``dist.sharding.stat_to_acc`` turns into this rank's piece of the
accumulator; the accumulator itself stays a plain tensor of the rank's
rows, a partial sum over the mesh dims that do not shard the batch, and
the plan layer sums it over those once per backward. The embedding's
table gradient and stat are computed on the rank's rows of the batch and
of the vocabulary (``norms.embedding_shards``); the expert taps' stat on
the rank's own experts (:func:`_expert_stat_sharded`). The token layout
takes the same route: each per-token stat from the rank's local shards as
a (B, S) DTensor (``dist.sharding.token_stat``, whose factor rule sums
each factor of a dense product over the mesh dims that shard its own
features before the multiply), the expert slots' through the rank's own
groups and experts (:func:`_expert_token_sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.core import norms as N
from repro_torch.core import provenance as _prov
from repro_torch.dist import sharding as _sh
from repro_torch.kernels import ops as kops
from repro_torch.nn.param import tree_flatten, tree_unflatten

_ACC_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class PexSpec:
    """Static instrumentation policy.

    enabled:     master switch. Off ⇒ every op is its plain counterpart.
    method:      'auto' | 'gram' | 'direct' | 'factorized' for dense taps.
    use_kernels: route dense stats through ``kernels.ops`` — the CUDA
                 gram and direct kernels for CUDA tensors (their plain
                 versions for CPU tensors). Off ⇒ the plain estimators of
                 ``core.norms`` on any device. Replaces the reference's
                 ``use_pallas``. The expert taps take the same choice:
                 the segmented kernel route under it, the scan/segment-sum
                 oracle without it; so do the token layout's stats (the
                 ``rowsumsq`` kernel or the plain ``_sumsq_tail``).
    groups:      acc column names; per-group norms (e.g. attn/mlp/embed).
                 ``"all"`` / ``"other"`` act as catch-all columns; an op
                 tapping a group not in ``groups`` (and with no catch-all
                 present) raises.
    tap_embeddings / tap_head: include embedding / lm-head params in the
                 norm.
    """
    enabled: bool = True
    method: str = "auto"
    use_kernels: bool = True
    groups: Tuple[str, ...] = ("all",)
    tap_embeddings: bool = True
    tap_head: bool = True

    def __post_init__(self):
        """Group patterns resolve by first match, so a duplicate or a
        shadowed catch-all would silently merge two groups' stats into
        one column — reject at construction, naming the conflict."""
        seen = {}
        dups = []
        for i, g in enumerate(self.groups):
            if g in seen:
                dups.append(f"{g!r} (columns {seen[g]} and {i})")
            else:
                seen[g] = i
        if dups:
            raise ValueError(
                f"duplicate pex group pattern(s): {', '.join(dups)}; "
                f"each entry of groups={self.groups} must name a distinct "
                f"accumulator column — stats for a repeated name would all "
                f"land in the first occurrence")
        catch_alls = [g for g in ("all", "other") if g in seen]
        if len(catch_alls) > 1:
            raise ValueError(
                f"shadowing catch-all group patterns {catch_alls} in "
                f"groups={self.groups}: 'all' always wins the catch-all "
                f"lookup, so the 'other' column could never receive a "
                f"stat — keep exactly one catch-all")

    def group_index(self, group: Optional[str]) -> int:
        if group is None:
            return 0
        if group in self.groups:
            return self.groups.index(group)
        for catch_all in ("all", "other"):
            if catch_all in self.groups:
                return self.groups.index(catch_all)
        raise ValueError(
            f"unknown pex group {group!r}: spec.groups={self.groups} has "
            f"no catch-all column ('all' or 'other'); add {group!r} to "
            f"groups or include a catch-all")

    @property
    def n_groups(self) -> int:
        return len(self.groups)


DISABLED = PexSpec(enabled=False)


@dataclasses.dataclass(frozen=True)
class ExampleLayout:
    """(B, n_groups) accumulator: per-example, per-group squared norms
    (the paper's object). Each op's stat lands in its group's column."""
    n_groups: int = 1

    def init(self, batch: int, device) -> torch.Tensor:
        return _sh.shard(torch.zeros((batch, self.n_groups),
                                     dtype=_ACC_DTYPE, device=device),
                         "batch", None)

    def add_example_stat(self, acc_bar, stat, group):
        """acc_bar with a (B,) stat added to one group column (a DTensor
        stat as this rank's accumulator piece)."""
        if _sh.is_dtensor(stat):
            stat = _sh.stat_to_acc(stat)
        out = acc_bar.clone()
        out[:, group] += stat.to(out.dtype)
        return out

    def add_dense(self, acc_bar, h, zbar, group, method, use_kernels):
        stat = N.stat_dense(h, zbar, method=method, use_kernels=use_kernels)
        return self.add_example_stat(acc_bar, stat, group)

    # the bias, scale and embedding stats take ``use_kernels`` for the token
    # layout's sake (its stats are kernel launches); these are plain
    # PyTorch on any device
    def add_bias(self, acc_bar, zbar, group, use_kernels):
        return self.add_example_stat(acc_bar, N.stat_bias(zbar), group)

    def add_scale(self, acc_bar, h, zbar, group, use_kernels):
        return self.add_example_stat(acc_bar, N.stat_elementwise(h, zbar),
                                     group)

    def add_embedding(self, acc_bar, ids, zbar, group, use_kernels):
        stat = N.stat_embedding(ids.reshape(ids.shape[0], -1),
                                zbar.reshape(zbar.shape[0], -1,
                                             zbar.shape[-1]))
        return self.add_example_stat(acc_bar, stat, group)

    def add_dense_batched(self, acc_bar, h, zbar, group, use_kernels):
        """Per-example-weight dense stat: h (B,[S,]p_in) against a batched
        weight (B,p_in,p_out), the multi-tenant LoRA form, where example j
        owns weight slice j (its tenant's gathered adapter factor). Example
        j's gradient is h_jᵀ z̄_j, the same outer product as the
        shared-weight case, so:

          * 2-D h — one row per example ⇒ the paper's §4 factorization is
            EXACT: s_j = ‖h_j‖²‖z̄_j‖².
          * 3-D h — the (B·S) rows go to the segmented estimator with
            example ids as segments (ONE launch across all examples and
            tenants; the ids repeat(arange(B), S) are sorted runs)."""
        if h.ndim == 2:
            return self.add_example_stat(acc_bar,
                                         N.stat_factorized(h, zbar), group)
        b, s = h.shape[0], h.shape[1]
        seg = torch.arange(b, device=h.device).repeat_interleave(s)
        stat = N.stat_direct_segmented(
            h.reshape(b * s, h.shape[-1]), zbar.reshape(b * s, -1), seg, b,
            method="kernel" if use_kernels else "xla")
        return self.add_example_stat(acc_bar, stat, group)

    def add_expert(self, acc_bar, x, zbar, seg, group, use_kernels,
                   tok=None):
        """MoE expert-buffer stat: x (E,C,d), zbar (E,C,f), seg (E,C)
        example ids (≥ batch ⇒ padding row): the grouped stat with one
        group of the whole batch. ``tok`` (the token layout's table) is
        not read."""
        return self.add_expert_grouped(acc_bar, x[None], zbar[None],
                                       seg[None], group, acc_bar.shape[0],
                                       use_kernels)

    def add_expert_grouped(self, acc_bar, x, zbar, seg, group, bg,
                           use_kernels, tok=None):
        """Grouped (GShard-local) expert stat: x (G,E,C,d), zbar
        (G,E,C,f), seg (G,E,C) GROUP-LOCAL example ids (≥ bg ⇒ padding
        row); group g's stats land at acc rows [g·bg, (g+1)·bg). ``tok``
        (the token layout's table) is not read.

        Example j's gradient for expert e is its own d×f block of the
        stacked weight, and an example's rows live only in its group, so
        each (group, expert, example) triple is one segment; all groups go
        to the segmented estimator as ONE flattened call (one kernel
        launch). Padding rows go to the drop bucket: the reference's
        (bg+1)-th composite per (group, expert), which only collected them
        to be thrown away, is not formed."""
        if _sh.is_dtensor(x) or _sh.is_dtensor(zbar):
            stat = _expert_stat_sharded(x, zbar, seg, bg, use_kernels)
        else:
            stat = _expert_stat(x, zbar, seg, bg, use_kernels)
        return self.add_example_stat(acc_bar, stat, group)


def _expert_stat(x, zbar, seg, bg: int, use_kernels: bool) -> torch.Tensor:
    """The grouped expert stat (``ExampleLayout.add_expert_grouped``) of
    plain operands: (G·bg,) f32."""
    ng, e, c, d = x.shape
    n_seg = ng * e * bg
    ge = (torch.arange(ng, device=seg.device)[:, None, None] * e
          + torch.arange(e, device=seg.device)[None, :, None])
    composite = torch.where((seg >= 0) & (seg < bg), ge * bg + seg, n_seg)
    stat = N.stat_direct_segmented(
        x.reshape(ng * e * c, d), zbar.reshape(ng * e * c, -1),
        composite.reshape(-1), n_seg,
        method="kernel" if use_kernels else "xla")
    return stat.reshape(ng, e, bg).sum(dim=1).reshape(ng * bg)


def _expert_stat_sharded(x, zbar, seg, bg: int, use_kernels: bool):
    """The grouped expert stat of DTensor buffers x (G,E,C,d), zbar
    (G,E,C,f) on each rank's local block (``seg`` cut alike): per mesh
    dim, ``Shard(0)`` where the groups are sharded (an example's rows live
    in one group), ``Partial`` where the experts are (each rank's experts
    are its own blocks of the gradient) or one feature dim is (where both
    are, x is gathered first), ``Replicate`` otherwise; a shard of the
    capacity axis is gathered (the rows of a segment add)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x, zbar, seg = N._dtensors(x, zbar, seg)
    mesh = x.device_mesh
    want = [list(t.placements) for t in (x, zbar, seg)]
    out = []
    for i in range(mesh.ndim):
        pl = []
        for t in (x, zbar):
            p = t.placements[i]
            if isinstance(p, Partial) or (isinstance(p, Shard)
                                          and p.dim % 4 == 2):
                p = Replicate()
            pl.append(p if not isinstance(p, Shard) else Shard(p.dim % 4))
        dims = [p.dim if isinstance(p, Shard) else -1 for p in pl]
        if 0 in dims or 1 in dims:
            dim = 0 if 0 in dims else 1
            pl = [Shard(dim)] * 3
            out.append(Shard(0) if dim == 0 else Partial())
        elif 3 in dims:
            pl = [Replicate() if dims[1] == 3 else pl[0], pl[1],
                  Replicate()]
            out.append(Partial())
        else:
            pl = [Replicate()] * 3
            out.append(Replicate())
        for w, p in zip(want, pl):
            w[i] = p
    local = [t.redistribute(mesh, w).to_local()
             if tuple(w) != tuple(t.placements) else t.to_local()
             for t, w in zip((x, zbar, seg), want)]
    stat = _expert_stat(*local, bg, use_kernels)
    return _sh.wrap_stat(stat, mesh, tuple(out), x.shape[0] * bg)


def _sumsq_tail(x: torch.Tensor, keep: int = 2) -> torch.Tensor:
    """Σ x² over all axes past the first ``keep`` (f32): the plain form."""
    return torch.sum(torch.square(x.to(_ACC_DTYPE)),
                     dim=tuple(range(keep, x.ndim)))


def _rowsumsq(x: torch.Tensor, keep: int, use_kernels: bool) -> torch.Tensor:
    """Σ x² over all axes past the first ``keep``: ``kernels.ops.rowsumsq``
    (the CUDA kernel for a CUDA tensor) under ``use_kernels``, else the
    plain :func:`_sumsq_tail`."""
    return kops.rowsumsq(x, keep) if use_kernels else _sumsq_tail(x, keep)


def _token_stat(ops, use_kernels: bool, elementwise: bool = False):
    """A per-token stat (B, S) of the operands: Σx² of one, the product
    ‖h_t‖²·‖z̄_t‖² of two, or ``elementwise`` Σ(h_t ⊙ z̄_t)². DTensor
    operands go through ``dist.sharding.token_stat`` (each rank's local
    shards; a (B, S) DTensor)."""
    if any(_sh.is_dtensor(x) for x in ops):
        return _sh.token_stat(N._dtensors(*ops),
                              lambda x: _rowsumsq(x, 2, use_kernels),
                              elementwise=elementwise)
    if elementwise:
        h, zbar = ops
        return _rowsumsq(h.to(_ACC_DTYPE) * zbar.to(_ACC_DTYPE), 2,
                         use_kernels)
    out = _rowsumsq(ops[0], 2, use_kernels)
    for x in ops[1:]:
        out = out * _rowsumsq(x, 2, use_kernels)
    return out


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """(B, S) accumulator: the paper's §4 factorization at token
    granularity, where it is exact for every dense layer of a sequence
    model — token t's contribution to ``∂L/∂W`` is the rank-1 outer
    product ``h_t z̄_tᵀ``, so ``s_{j,t} = ‖h_{j,t}‖²·‖z̄_{j,t}‖²``. Group
    columns do not apply; every tap folds into the one (B, S) map. Each
    stat is a row-wise Σx² over (B, S) rows: one ``rowsumsq`` launch per
    operand under ``use_kernels`` (two per dense or expert tap, one per
    bias, scale or embedding tap). DTensor operands: each stat from the
    rank's local shards (:func:`_token_stat`), added as the rank's piece
    of the accumulator (``dist.sharding.stat_to_acc``)."""
    seq: int

    def init(self, batch: int, device) -> torch.Tensor:
        return _sh.shard(torch.zeros((batch, self.seq), dtype=_ACC_DTYPE,
                                     device=device), "batch", None)

    @staticmethod
    def _add(acc_bar, stat):
        if _sh.is_dtensor(stat):
            stat = _sh.stat_to_acc(stat)
        return acc_bar + stat

    def add_dense(self, acc_bar, h, zbar, group, method, use_kernels):
        if h.ndim != 3:
            raise ValueError(
                f"TokenLayout dense tap needs (B, S, p) activations, got "
                f"shape {tuple(h.shape)}; per-token factorization is only "
                f"exact when each token is one row of the matmul")
        return self._add(acc_bar, _token_stat((h, zbar), use_kernels))

    def add_dense_batched(self, acc_bar, h, zbar, group, use_kernels):
        """Batched-weight dense stat at token granularity: token t's
        contribution to its example's weight slice is still the rank-1
        outer product h_t z̄_tᵀ — the §4 factorization is exact per token,
        whichever example owns the weight."""
        if h.ndim != 3:
            raise ValueError(
                f"TokenLayout dense_batched tap needs (B, S, p) "
                f"activations, got shape {tuple(h.shape)}")
        return self._add(acc_bar, _token_stat((h, zbar), use_kernels))

    def add_bias(self, acc_bar, zbar, group, use_kernels):
        # token t's bias contribution is z̄_t itself
        self._check_rank(zbar, "bias_add")
        return self._add(acc_bar, _token_stat((zbar,), use_kernels))

    def add_scale(self, acc_bar, h, zbar, group, use_kernels):
        # token t's gain contribution is h_t ⊙ z̄_t
        self._check_rank(zbar, "scale")
        return self._add(acc_bar, _token_stat((h, zbar), use_kernels,
                                              elementwise=True))

    def add_embedding(self, acc_bar, ids, zbar, group, use_kernels):
        # one-hot row ⇒ ‖h_t‖² = 1 ⇒ the stat is ‖z̄_t‖²
        self._check_rank(zbar, "embedding")
        return self._add(acc_bar, _token_stat((zbar,), use_kernels))

    def _check_rank(self, zbar, op: str) -> None:
        if zbar.ndim < 3:
            raise ValueError(
                f"TokenLayout {op} tap needs (B, S, ...) activations, got "
                f"shape {tuple(zbar.shape)}; a rank-2 stat would silently "
                f"broadcast into the (B, S) accumulator")

    def _scatter_slot_stats(self, acc_bar, stat, target, valid):
        """Add per-slot stats into the flat (B·S) token map; invalid slots
        (capacity padding) are masked AND sent to one slot past the end,
        which is dropped. ``index_put_`` with ``accumulate`` sorts the
        targets, so a token's top-k slots add in the same order on every
        run."""
        b, s = acc_bar.shape
        tgt = torch.where(valid, target, b * s).reshape(-1)
        upd = torch.where(valid, stat, 0.0).reshape(-1).to(acc_bar.dtype)
        flat = torch.cat([acc_bar.reshape(-1), acc_bar.new_zeros(1)])
        flat.index_put_((tgt,), upd, accumulate=True)
        return flat[:b * s].reshape(b, s)

    def add_expert(self, acc_bar, x, zbar, seg, group, use_kernels, *,
                   tok):
        """Token-granularity expert stat: x (E,C,d), zbar (E,C,f), tok
        (E,C) flat token positions (∉ [0, B·S) ⇒ padding slot). Every
        capacity slot holds ONE token's row, so token t's contribution to
        the expert weight is the rank-1 outer product x_slot z̄_slotᵀ — the
        §4 factorization is exact per slot — and a token's top-k slots
        land in distinct expert matrices, so summing its slot stats into
        the (B, S) map is exact too. ``seg`` is not read."""
        b, s = acc_bar.shape
        return self.add_expert_grouped(acc_bar, x[None], zbar[None],
                                       seg[None], group, b, use_kernels,
                                       tok=tok[None])

    def add_expert_grouped(self, acc_bar, x, zbar, seg, group, bg,
                           use_kernels, *, tok):
        """Grouped-dispatch variant: x (G,E,C,d), zbar (G,E,C,f), tok
        (G,E,C) GROUP-LOCAL flat token ids (∉ [0, bg·S) ⇒ padding slot);
        group g covers the flat tokens [g·bg·S, (g+1)·bg·S). DTensor
        buffers: :func:`_expert_token_sharded`."""
        if _sh.is_dtensor(x) or _sh.is_dtensor(zbar):
            return self._add(acc_bar, _expert_token_sharded(
                self, x, zbar, tok, bg, use_kernels))
        stat = _rowsumsq(x, 3, use_kernels) * _rowsumsq(zbar, 3, use_kernels)
        return self._scatter_groups(acc_bar, stat, tok, bg)

    def _scatter_groups(self, acc_bar, stat, tok, bg):
        """(G, E, C) slot stats scattered into ``acc_bar``, the (G·bg, S)
        map of the groups' rows, through the group-local table ``tok``."""
        tg = bg * self.seq
        valid = (tok >= 0) & (tok < tg)
        glob = torch.arange(tok.shape[0], device=tok.device)[:, None,
                                                              None] * tg + tok
        return self._scatter_slot_stats(acc_bar, stat, glob, valid)


def _expert_token_sharded(layout: TokenLayout, x, zbar, tok, bg: int,
                          use_kernels: bool):
    """The token-granularity expert stat of DTensor buffers x (G,E,C,d),
    zbar (G,E,C,f) (``tok`` cut alike), as the (G·bg, S) DTensor map:
    per mesh dim, ``Shard(0)`` where the groups are sharded (the rank's
    groups are its own rows, so its group-local table is offset to
    them), ``Partial`` where the experts are (the rank's slots scattered
    into the whole map's rows), and where a feature dim is sharded each
    factor summed over it before the product
    (``dist.sharding.reduce_factor``), the map then whole; a shard of the
    capacity axis is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x, zbar, tok = N._dtensors(x, zbar, tok)
    mesh = x.device_mesh
    want = [list(t.placements) for t in (x, zbar, tok)]
    out = []
    for i in range(mesh.ndim):
        pl = []
        for t in (x, zbar):
            p = t.placements[i]
            if isinstance(p, Partial) or (isinstance(p, Shard)
                                          and p.dim % 4 == 2):
                p = Replicate()
            pl.append(p if not isinstance(p, Shard) else Shard(p.dim % 4))
        dims = [p.dim if isinstance(p, Shard) else -1 for p in pl]
        if 0 in dims or 1 in dims:
            dim = 0 if 0 in dims else 1
            pl = [Shard(dim)] * 3
            out.append(Shard(0) if dim == 0 else Partial())
        else:
            pl = [p if d == 3 else Replicate() for p, d in zip(pl, dims)] \
                + [Replicate()]
            out.append(Replicate())
        for w, p in zip(want, pl):
            w[i] = p
    xl, zl, tl = [t.redistribute(mesh, w).to_local()
                  if tuple(w) != tuple(t.placements) else t.to_local()
                  for t, w in zip((x, zbar, tok), want)]
    slots = tuple(x.shape[:3])
    factors = []
    for t, w in zip((xl, zl), want[:2]):
        pl = tuple(Shard(p.dim) if isinstance(p, Shard) and p.dim < 3 else
                   Partial() if isinstance(p, Shard) else Replicate()
                   for p in w)
        factors.append(_sh.reduce_factor(_rowsumsq(t, 3, use_kernels),
                                         mesh, pl, slots)[0])
    rows = tl.shape[0] * bg
    local = layout._scatter_groups(
        torch.zeros((rows, layout.seq), dtype=_ACC_DTYPE, device=tl.device),
        factors[0] * factors[1], tl, bg)
    return _sh.wrap_stat(local, mesh, tuple(out), (x.shape[0] * bg,
                                                   layout.seq))


@dataclasses.dataclass
class BackwardMode:
    """What the next backward through a live tap computes: the per-example
    stats (``norms``), the parameter gradients (``grads``), or both. Holds
    no tensors, so the autograd graph can keep a reference to it without
    a reference cycle."""
    norms: bool = True
    grads: bool = True


def _lead_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last."""
    return torch.sum(x, dim=tuple(range(x.ndim - 1)))


def _weight_grad(h: torch.Tensor, zbar: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """dW = Σ over rows of h_rowᵀ z̄_row, in w's dtype."""
    dw = h.reshape(-1, h.shape[-1]).t() @ zbar.reshape(-1, zbar.shape[-1])
    return dw.to(w.dtype)


# ---------------------------------------------------------------------------
# the tapped ops: each forward returns (z, acc_out); each backward returns
# the standard cotangents and acc_bar + scatter(stat), as the mode allows
# ---------------------------------------------------------------------------

class _Dense(torch.autograd.Function):
    """z = h @ w, h (B,[S,]p_in), w (p_in, p_out)."""

    @staticmethod
    def forward(ctx, h, w, acc, mode, layout, group, method, use_kernels,
                given=None):
        ctx.save_for_backward(h, w)
        ctx.cfg = (mode, layout, group, method, use_kernels)
        return _product(h, w, given), acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        h, w = ctx.saved_tensors
        mode, layout, group, method, use_kernels = ctx.cfg
        dh = dw = dacc = None
        if ctx.needs_input_grad[0]:
            dh = torch.matmul(zbar, w.t()).to(h.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dw = _weight_grad(h, zbar, w)
        if mode.norms:
            dacc = layout.add_dense(acc_bar, h, zbar, group, method,
                                    use_kernels)
        return dh, dw, dacc, None, None, None, None, None, None


class _Product(torch.autograd.Function):
    """z = h @ w with no stat: an inert tap's dense product, or an untapped
    one (:func:`matmul`), inside a checkpointed block, where the recompute
    may hand over the product the forward kept (``given``)."""

    @staticmethod
    def forward(ctx, h, w, given):
        ctx.save_for_backward(h, w)
        return _product(h, w, given)

    @staticmethod
    def backward(ctx, zbar):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = torch.matmul(zbar, w.t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(h, zbar, w)
        return dh, dw, None


def _product(h, w, given):
    """``h @ w``, or ``given`` where a recompute already has it."""
    return torch.matmul(h, w) if given is None else given


class _DenseBatched(torch.autograd.Function):
    """z = einsum('b...i,bio->b...o', h, w), h (B,[S,]p_in), w (B, p_in,
    p_out): per-example weights (the multi-tenant LoRA form)."""

    @staticmethod
    def forward(ctx, h, w, acc, mode, layout, group, use_kernels):
        ctx.save_for_backward(h, w)
        ctx.cfg = (mode, layout, group, use_kernels)
        return torch.einsum("b...i,bio->b...o", h, w), acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        h, w = ctx.saved_tensors
        mode, layout, group, use_kernels = ctx.cfg
        dh = dw = dacc = None
        if ctx.needs_input_grad[0]:
            dh = torch.einsum("b...o,bio->b...i", zbar, w).to(h.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dw = torch.einsum("b...i,b...o->bio", h, zbar).to(w.dtype)
        if mode.norms:
            dacc = layout.add_dense_batched(acc_bar, h, zbar, group,
                                            use_kernels)
        return dh, dw, dacc, None, None, None, None


class _Bias(torch.autograd.Function):
    """z = x + b."""

    @staticmethod
    def forward(ctx, x, b, acc, mode, layout, group, use_kernels):
        ctx.cfg = (mode, layout, group, use_kernels)
        return x + b, acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        mode, layout, group, use_kernels = ctx.cfg
        db = dacc = None
        if mode.grads and ctx.needs_input_grad[1]:
            db = _lead_sum(zbar)
        if mode.norms:
            dacc = layout.add_bias(acc_bar, zbar, group, use_kernels)
        return zbar, db, dacc, None, None, None, None


class _Scale(torch.autograd.Function):
    """z = g ⊙ h (elementwise params: RMSNorm gains)."""

    @staticmethod
    def forward(ctx, h, g, acc, mode, layout, group, use_kernels):
        ctx.save_for_backward(h, g)
        ctx.cfg = (mode, layout, group, use_kernels)
        return h * g, acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        h, g = ctx.saved_tensors
        mode, layout, group, use_kernels = ctx.cfg
        dh = dg = dacc = None
        if ctx.needs_input_grad[0]:
            dh = (zbar * g).to(h.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dg = _lead_sum(zbar * h).to(g.dtype)
        if mode.norms:
            dacc = layout.add_scale(acc_bar, h, zbar, group, use_kernels)
        return dh, dg, dacc, None, None, None, None


class _Embed(torch.autograd.Function):
    """z = table[ids]; dtable by ``norms.add_rows``: each id's rows add in
    one fixed order, so the gradient has the same bits on every run."""

    @staticmethod
    def forward(ctx, table, ids, acc, mode, layout, group, use_kernels):
        ctx.save_for_backward(ids)
        ctx.cfg = (mode, layout, group, use_kernels, table.shape,
                   table.dtype, getattr(table, "placements", None))
        if _sh.is_dtensor(table):
            # the rank's rows and vocabulary (norms.embedding_lookup)
            return N.embedding_lookup(table, ids), acc.clone()
        return table[ids], acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        (ids,) = ctx.saved_tensors
        mode, layout, group, use_kernels, shape, dtype, placements = ctx.cfg
        dtable = dacc = None
        if placements is not None:
            # a DTensor table: the rank's rows of the batch and of the
            # vocabulary (norms.embedding_shards)
            # (the token stat, ‖z̄_t‖², reads no vocabulary row)
            token = isinstance(layout, TokenLayout)
            dtable, stat = N.embedding_shards(
                ids, zbar.to(dtype), shape, placements,
                grads=mode.grads and ctx.needs_input_grad[0],
                norms=mode.norms and not token)
            if stat is not None:
                dacc = layout.add_example_stat(acc_bar, stat, group)
            elif mode.norms:
                dacc = layout.add_embedding(acc_bar, ids, zbar, group,
                                            use_kernels)
            return dtable, None, dacc, None, None, None, None
        if mode.grads and ctx.needs_input_grad[0]:
            dtable = N.add_rows(
                torch.zeros(shape, dtype=dtype, device=zbar.device),
                ids.reshape(-1), zbar.reshape(-1, shape[-1]).to(dtype))
        if mode.norms:
            dacc = layout.add_embedding(acc_bar, ids, zbar, group,
                                        use_kernels)
        return dtable, None, dacc, None, None, None, None


def _expert_einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` for the three expert products over the
    (G, E, C, ·) capacity buffer — ``gecd,edf->gecf`` (the forward),
    ``gecf,edf->gecd`` (dx) and ``gecd,gecf->edf`` (dW) — on each rank's
    local blocks where either operand is a DTensor: per mesh dim, the
    buffer's groups (dim 0) or experts (dim 1) where it shards them, the
    rest whole; dW is then a ``Partial`` sum over the group shards and
    the rank's experts' block over the expert shards. (DTensor's own
    einsum rule flattens a sharded dim on some PyTorch releases.)"""
    if not (_sh.is_dtensor(a) or _sh.is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    buf = a if _sh.is_dtensor(a) else b
    mesh = buf.device_mesh
    wgrad = eq.endswith("->edf")
    pa, pb, po = [], [], []
    for p in buf.placements:
        d = p.dim % 4 if isinstance(p, Shard) else None
        if d == 0:
            pa.append(Shard(0))
            pb.append(Shard(0) if wgrad else Replicate())
            po.append(Partial() if wgrad else Shard(0))
        elif d == 1:
            pa.append(Shard(1))
            pb.append(Shard(1) if wgrad else Shard(0))
            po.append(Shard(0) if wgrad else Shard(1))
        else:
            pa.append(Replicate()), pb.append(Replicate())
            po.append(Replicate())

    def local(x, pl):
        if not _sh.is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, pl).to_local(grad_placements=pl)
    out = torch.einsum(eq, local(a, pa), local(b, pb))
    if wgrad:
        shape = (a.shape[1], a.shape[3], b.shape[3])
    else:
        shape = tuple(a.shape[:3]) + (b.shape[2] if eq.endswith("gecf")
                                      else b.shape[1],)
    return DTensor.from_local(out, mesh, po, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


class _DenseExpert(torch.autograd.Function):
    """z = einsum('gecd,edf->gecf', x, w): the grouped MoE expert matmul
    over the (G, E, C) capacity buffer; seg (G,E,C) holds each row's
    group-local example id (≥ bg ⇒ padding row), tok (G,E,C) its
    group-local flat token id (the token layout's table)."""

    @staticmethod
    def forward(ctx, x, w, seg, tok, acc, mode, layout, group, bg,
                use_kernels):
        ctx.save_for_backward(x, w, seg, tok)
        ctx.cfg = (mode, layout, group, bg, use_kernels)
        return _expert_einsum("gecd,edf->gecf", x, w), acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        x, w, seg, tok = ctx.saved_tensors
        mode, layout, group, bg, use_kernels = ctx.cfg
        dx = dw = dacc = None
        if ctx.needs_input_grad[0]:
            dx = _expert_einsum("gecf,edf->gecd", zbar, w).to(x.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dw = _expert_einsum("gecd,gecf->edf", x, zbar).to(w.dtype)
        if mode.norms:
            dacc = layout.add_expert_grouped(acc_bar, x, zbar, seg, group,
                                             bg, use_kernels, tok=tok)
        return dx, dw, None, None, dacc, None, None, None, None, None


# ---------------------------------------------------------------------------
# tap-site provenance — the metadata the static analyzer consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PexOpInfo:
    """Shape of one tapped op as an analysis trace records it.

    Slots index the op's tensor operands (the leading arguments of its
    ``apply``): ``weight_slots`` hold the parameter whose per-example stat
    the op registers (the gradient path the tap covers), ``data_slots`` the
    operands whose gradient flows *through* the op to earlier layers; the
    last operand is always the accumulator. ``analysis.coverage`` decides
    from this which taint survives an op: a parameter reaching the loss
    only through weight slots is tapped, one that also reaches it through
    any plain op is undercounted."""
    name: str
    weight_slots: Tuple[int, ...]
    data_slots: Tuple[int, ...]
    n_operands: int


#: tapped ``autograd.Function`` → op provenance (the reference's
#: ``PEX_OPS``, keyed there by the registered backward rule)
PEX_OPS = {
    _Dense: PexOpInfo("dense", (1,), (0,), 3),
    _DenseBatched: PexOpInfo("dense_batched", (1,), (0,), 3),
    _DenseExpert: PexOpInfo("dense_expert_grouped", (1,), (0, 2, 3), 5),
    _Bias: PexOpInfo("bias_add", (1,), (0,), 3),
    _Scale: PexOpInfo("scale", (1,), (0,), 3),
    _Embed: PexOpInfo("embedding", (0,), (1,), 3),
}
#: ``Tap.dense_expert``: the grouped op on one group, recorded as the
#: reference's ungrouped site on its own (E, C, ...) operands
DENSE_EXPERT = PexOpInfo("dense_expert", (1,), (0, 2, 3), 5)


def identify_pex_op(fn) -> Optional[PexOpInfo]:
    """The provenance of a tapped ``autograd.Function`` (None for any
    other, e.g. the flash attention op)."""
    return PEX_OPS.get(fn)


def _site(info: PexOpInfo, operands, run):
    """``run()`` → (z, acc_out); inside an analysis trace, recorded as one
    tap site on ``operands``."""
    rec = _prov.RECORDER
    if rec is None:
        return run()
    return rec.tap_site(info, operands, run)


def _apply(fn, *args):
    """``fn.apply(*args)``, recorded as a tap site inside a trace."""
    if _prov.RECORDER is None:
        return fn.apply(*args)
    info = PEX_OPS[fn]
    return _site(info, args[:info.n_operands], lambda: fn.apply(*args))


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

class Tap:
    """Tap collector: owns the accumulator so models never thread it.

        tap = Tap(spec, acc=layout.init(batch, device).requires_grad_())
        z = tap.dense(h, w, group="mlp")
        ...
        acc_out = tap.carry()

    ``mode`` (a :class:`BackwardMode`) is read by every op's backward; the
    plan layer sets it with :meth:`set_mode` before each backward.
    """
    __slots__ = ("spec", "layout", "mode", "_acc", "_token_losses")

    def __init__(self, spec: PexSpec, acc: Optional[torch.Tensor] = None,
                 layout=None):
        self.spec = spec
        self.layout = layout if layout is not None \
            else ExampleLayout(spec.n_groups)
        self.mode = BackwardMode()
        self._acc = acc
        self._token_losses = None

    @property
    def live(self) -> bool:
        """True when ops actually register stats."""
        return self.spec.enabled and self._acc is not None

    def set_mode(self, *, norms: bool, grads: bool) -> None:
        """Choose what the next backward through this tap computes."""
        self.mode.norms = norms
        self.mode.grads = grads

    def carry(self):
        """Current accumulator value."""
        return self._acc

    def token_loss(self, token_losses: torch.Tensor) -> torch.Tensor:
        """Register the per-token loss map (an identity op); inert taps
        record nothing."""
        if self.live:
            self._token_losses = token_losses if self._token_losses is None \
                else self._token_losses + token_losses
        return token_losses

    def token_losses(self) -> Optional[torch.Tensor]:
        """The registered per-token loss map (or None)."""
        return self._token_losses

    def dense(self, h, w, *, group: str = "all",
              method: Optional[str] = None) -> torch.Tensor:
        """Instrumented matmul. Plain matmul when the tap is inert. A
        DTensor product is laid out as its operands say
        (``dist.sharding.dense_layout``)."""
        w = _sh.gathered(w, h)
        frame = _FRAME
        if frame is not None:
            return _sh.dense_layout(frame.dense(self, h, w, group, method),
                                    h, w)
        if not self.live:
            return _sh.dense_layout(torch.matmul(h, w), h, w)
        z, self._acc = _apply(
            _Dense, h, w, self._acc, self.mode, self.layout,
            self.spec.group_index(group), method or self.spec.method,
            self.spec.use_kernels)
        return _sh.dense_layout(z, h, w)

    def dense_batched(self, h, w, *, group: str = "all",
                      method: Optional[str] = None) -> torch.Tensor:
        """Instrumented per-example-weight matmul: h (B,[S,]p_in), w (B,
        p_in, p_out) — example j multiplies weight slice j (its tenant's
        gathered LoRA factor). Plain einsum when the tap is inert. The
        example stat of 3-D h takes the expert taps' segmented route (the
        kernel under ``spec.use_kernels``); ``method`` is not read, as the
        segmented estimator has one form per route."""
        if not self.live:
            return torch.einsum("b...i,bio->b...o", h, w)
        z, self._acc = _apply(
            _DenseBatched, h, w, self._acc, self.mode, self.layout,
            self.spec.group_index(group), self.spec.use_kernels)
        return z

    def bias_add(self, x, b, *, group: str = "all") -> torch.Tensor:
        b = _sh.gathered(b, x)
        if not self.live:
            return x + b
        z, self._acc = _apply(_Bias, x, b, self._acc, self.mode, self.layout,
                              self.spec.group_index(group),
                              self.spec.use_kernels)
        return z

    def scale(self, h, g, *, group: str = "all") -> torch.Tensor:
        g = _sh.gathered(g, h)
        if not self.live:
            return h * g
        z, self._acc = _apply(_Scale, h, g, self._acc, self.mode, self.layout,
                              self.spec.group_index(group),
                              self.spec.use_kernels)
        return z

    def embedding(self, table, ids, *, group: str = "embed") -> torch.Tensor:
        """``table[ids]``, tapped when the tap is live; a DTensor table is
        looked up on the rank's rows and vocabulary either way
        (``norms.embedding_lookup``: DTensor's own index rule, and its
        backward's ``index_put``, fail on some PyTorch releases)."""
        if not (self.live and self.spec.tap_embeddings):
            if _sh.is_dtensor(table):
                return N.embedding_lookup(table, ids)
            return table[ids]
        z, self._acc = _apply(_Embed, table, ids, self._acc, self.mode,
                              self.layout, self.spec.group_index(group),
                              self.spec.use_kernels)
        return z

    def _expert_tok(self, seg, tok):
        """The slot → token-position table: required at token granularity
        (the capacity shuffle loses positions without it; ``nn.moe``
        passes its dispatch sort's table); at example granularity an
        absent table becomes an inert sentinel."""
        if tok is not None:
            return tok
        if isinstance(self.layout, TokenLayout):
            raise ValueError(
                "granularity='token' expert taps need token positions: "
                "pass tok= (slot → flat token id, as produced by "
                "nn.moe's dispatch sort); without it the (B, S) map "
                "cannot be scattered")
        return torch.full_like(seg, -1)

    def dense_expert_grouped(self, x, w, seg, bg: int, tok=None, *,
                             group: str = "moe") -> torch.Tensor:
        """Grouped instrumented expert matmul. x (G,E,C,d), w (E,d,f),
        seg (G,E,C) group-local example ids (≥ bg ⇒ padding row, excluded
        from the stats); tok (G,E,C) group-local flat token ids (≥ bg·S ⇒
        padding row), required for TokenLayout."""
        if not self.live:
            return torch.einsum("gecd,edf->gecf", x, w)
        tok = self._expert_tok(seg, tok)
        z, self._acc = _apply(
            _DenseExpert, x, w, seg, tok, self._acc, self.mode, self.layout,
            self.spec.group_index(group), bg, self.spec.use_kernels)
        return z

    def dense_expert(self, x, w, seg, tok=None, *,
                     group: str = "moe") -> torch.Tensor:
        """Instrumented per-expert matmul. x (E,C,d), w (E,d,f), seg (E,C)
        example ids (≥ batch ⇒ padding row); tok (E,C) flat token
        positions (≥ B·S ⇒ padding row), required for TokenLayout: the
        grouped op with one group of the whole batch."""
        if not self.live:
            return torch.einsum("ecd,edf->ecf", x, w)
        tok = self._expert_tok(seg, tok)

        def run():
            z = self.dense_expert_grouped(x[None], w, seg[None],
                                          self._acc.shape[0], tok[None],
                                          group=group)[0]
            return z, self._acc
        z, self._acc = _site(DENSE_EXPERT, (x, w, seg, tok, self._acc), run)
        return z


#: Shared inert tap: every op is its plain counterpart.
NULL = Tap(DISABLED)


def matmul(h, w) -> torch.Tensor:
    """``h @ w`` for an untapped product with a 2-D weight (a LoRA site's
    frozen base): plain outside a checkpointed block; inside one, the
    ``"dots"`` policy keeps its output as it keeps ``Tap.dense``'s."""
    frame = _FRAME
    if frame is None:
        return torch.matmul(h, w)
    return frame.dense(None, h, w, None, None)


# ---------------------------------------------------------------------------
# rematerialization (module docstring)
# ---------------------------------------------------------------------------

POLICIES = ("full", "dots")

#: the checkpointed block running now (its forward or its recompute), or
#: None
_FRAME = None


class _Stop(Exception):
    """Raised by a recompute once the last tensor its forward saved has
    been made again: the rest of the block is dead in the backward."""


class _Remat:
    """One call of a checkpointed block.

    The forward counts the tensors autograd saves (each becomes its index)
    and, for the dense products, notes which one's own saves are the last
    (``tail``: its product is dead in the backward) and, under ``"dots"``,
    keeps each product. The first unpack of a backward re-runs the block
    on detached copies of its inputs with the same ``requires_grad``, keeps
    what it saves by index, and stops at the last; each unpack hands its
    tensor over and drops it. A second backward (a new graph task) re-runs
    the block again."""

    def __init__(self, fn, tap: "Tap", policy: str, args):
        leaves, self.treedef = tree_flatten(args)
        if tap.live and not any(x is tap for x in leaves):
            # the frame may not hold the tap: it holds the accumulator,
            # whose graph holds the frame (a cycle the collector cannot see
            # through autograd's nodes), and the recompute runs on a copy
            raise ValueError("a checkpointed block takes its live tap as an "
                             "argument; it may not close over it")
        self.leaves = [(_TAP, None) if x is tap else _hold(x)
                       for x in leaves]
        self.entry = {k: _hold(v) for k, v in _tap_state(tap).items()}
        self.fn, self.tap_cls, self.policy = fn, type(tap), policy
        self.n_saved = 0
        self.meta = []           # (shape, dtype) of each saved tensor
        self.products = []
        self.tail = None
        self.recomputing = False
        self._dense = 0          # dense products met in this run
        self._open = None        # the dense product being applied
        self._gid = None
        self._saved = None
        self._made = 0

    # -- the forward ---------------------------------------------------------
    def forward(self, args):
        global _FRAME
        prev, _FRAME = _FRAME, self
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                return self.fn(*args)
        finally:
            _FRAME = prev

    def _pack(self, t):
        i = self.n_saved
        self.n_saved += 1
        self.meta.append((t.shape, t.dtype))
        self.tail = self._open
        return i

    def _unpack(self, i):
        gid = torch._C._current_graph_task_id()
        if gid != self._gid:
            self._recompute()
            self._gid = gid
            torch.autograd.Variable._execution_engine.queue_callback(
                self._release)
        t = self._saved[i]
        if t is None:
            raise RuntimeError(
                "a checkpointed block's saved tensor was unpacked twice in "
                "one backward; the recompute hands each over once")
        self._saved[i] = None
        return t

    def _release(self):
        self._saved = None

    # -- the recompute -------------------------------------------------------
    def _recompute(self):
        global _FRAME
        # the block re-runs on a copy of the tap as it was at its entry
        copy = self.tap_cls.__new__(self.tap_cls)
        _set_tap_state(copy, self.entry)
        args = tree_unflatten(self.treedef, [
            copy if x is _TAP else _fresh((x, flag))
            for x, flag in self.leaves])
        self._saved = [None] * self.n_saved
        self._made = self._dense = 0
        self.recomputing = True
        prev, _FRAME = _FRAME, self
        rec = _prov.RECORDER
        if rec is not None:
            rec.remat += 1
        try:
            with spans.span("remat.recompute"), torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(self._keep,
                                                              _refuse):
                self.fn(*args)
        except _Stop:
            pass
        finally:
            if rec is not None:
                rec.remat -= 1
            _FRAME = prev
            self.recomputing = False
        if self._made != self.n_saved:
            raise RuntimeError(
                f"a checkpointed block's recompute saved {self._made} "
                f"tensors where its forward saved {self.n_saved}: the "
                f"block must run the same ops on the same inputs")

    def _keep(self, t):
        if self._made >= self.n_saved \
                or (t.shape, t.dtype) != self.meta[self._made]:
            raise RuntimeError(
                f"a checkpointed block's recompute saved, as tensor "
                f"{self._made}, a {t.dtype} {tuple(t.shape)} where its "
                f"forward saved "
                f"{self.meta[self._made] if self._made < self.n_saved else 'nothing'}"
                f": the block must run the same ops on the same inputs")
        self._saved[self._made] = t
        self._made += 1
        if self._made == self.n_saved:
            raise _Stop
        return None

    # -- the dense products --------------------------------------------------
    def dense(self, tap: Optional["Tap"], h, w, group, method):
        """One dense product of the block: ``tap``'s tapped op when it is
        live, else :class:`_Product`; the product handed over by
        ``"dots"`` or skipped at the dead tail in a recompute, kept by
        ``"dots"`` in the forward."""
        k = self._dense
        self._dense += 1
        given = None
        if self.recomputing:
            if self.policy == "dots":
                given = self.products[k].detach()
            elif k == self.tail and not (_sh.is_dtensor(h)
                                         or _sh.is_dtensor(w)):
                # its own saves are the forward's last: the recompute stops
                # right after them, so the product is never read
                given = h.new_empty(h.shape[:-1] + w.shape[-1:],
                                    dtype=torch.result_type(h, w))
        self._open = k
        try:
            if tap is not None and tap.live:
                z, tap._acc = _apply(
                    _Dense, h, w, tap._acc, tap.mode, tap.layout,
                    tap.spec.group_index(group), method or tap.spec.method,
                    tap.spec.use_kernels, given)
            else:
                z = _Product.apply(h, w, given)
        finally:
            self._open = None
        if self.policy == "dots" and not self.recomputing:
            self.products.append(z.detach())
        return z


def recomputing() -> bool:
    """Is a backward re-running a checkpointed block now?"""
    return _FRAME is not None and _FRAME.recomputing


def _hold(x):
    """A block input as the recompute reads it: a tensor detached, with
    its ``requires_grad``."""
    if isinstance(x, torch.Tensor):
        return x.detach(), x.requires_grad
    return x, None


def _fresh(held):
    """A held input as a new leaf of the recompute's own graph."""
    x, flag = held
    return x if flag is None else x.detach().requires_grad_(flag)


def _tap_state(tap) -> dict:
    """Every slot a tap holds (its class's and its subclasses'; a
    subclass may count its calls)."""
    names = {n for c in type(tap).__mro__
             for n in getattr(c, "__slots__", ()) if n != "__weakref__"}
    names.update(getattr(tap, "__dict__", {}))
    return {n: getattr(tap, n) for n in names if hasattr(tap, n)}


def _set_tap_state(tap, held: dict) -> None:
    """``tap`` as it was at a block's entry (``_hold`` of each slot), its
    tensors (the accumulator) new leaves of the recompute's graph."""
    for k, v in held.items():
        setattr(tap, k, _fresh(v))


#: where a checkpointed block's arguments held its tap
_TAP = object()


def _refuse(_):
    raise RuntimeError("a checkpointed block's recompute is not "
                       "differentiated")


def checkpoint(fn: Callable, *, tap: Optional[Tap] = None,
               policy: str = "full") -> Callable:
    """``fn`` rematerialized (module docstring), the reference's
    ``taps.checkpoint``: returns a function with ``fn``'s signature whose
    backward re-runs ``fn`` on its arguments. Tensors ``fn`` closes over
    are read again as they are then. Where no backward can follow
    (gradients off) the call is plain, and so it is under a ``torch.func``
    transform (the ``vmap(grad)`` oracle), which refuses saved-tensor
    hooks: rematerializing changes no value, so the plain call computes
    the same function."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r}: expected one of "
                         f"{POLICIES}")
    tap = NULL if tap is None else tap

    def run(*args):
        if not torch.is_grad_enabled() \
                or torch._C._are_functorch_transforms_active():
            return fn(*args)
        return _Remat(fn, tap, policy, args).forward(args)
    return run
