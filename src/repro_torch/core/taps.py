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

Not in this slice: the provenance table for the static analyzer, and
``scan`` / ``checkpoint`` (the port runs layers in a Python loop without
recompute). ``dist.sharding.shard`` constraints are dropped: they are
identities off a TPU mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import norms as N
from repro_torch.kernels import ops as kops

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
        return torch.zeros((batch, self.n_groups), dtype=_ACC_DTYPE,
                           device=device)

    def add_example_stat(self, acc_bar, stat, group):
        """acc_bar with a (B,) stat added to one group column."""
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
        ng, e, c, d = x.shape
        n_seg = ng * e * bg
        ge = (torch.arange(ng, device=seg.device)[:, None, None] * e
              + torch.arange(e, device=seg.device)[None, :, None])
        composite = torch.where((seg >= 0) & (seg < bg), ge * bg + seg,
                                n_seg)
        stat = N.stat_direct_segmented(
            x.reshape(ng * e * c, d), zbar.reshape(ng * e * c, -1),
            composite.reshape(-1), n_seg,
            method="kernel" if use_kernels else "xla")
        stat = stat.reshape(ng, e, bg).sum(dim=1).reshape(ng * bg)
        return self.add_example_stat(acc_bar, stat, group)


def _sumsq_tail(x: torch.Tensor, keep: int = 2) -> torch.Tensor:
    """Σ x² over all axes past the first ``keep`` (f32): the plain form."""
    return torch.sum(torch.square(x.to(_ACC_DTYPE)),
                     dim=tuple(range(keep, x.ndim)))


def _rowsumsq(x: torch.Tensor, keep: int, use_kernels: bool) -> torch.Tensor:
    """Σ x² over all axes past the first ``keep``: ``kernels.ops.rowsumsq``
    (the CUDA kernel for a CUDA tensor) under ``use_kernels``, else the
    plain :func:`_sumsq_tail`."""
    return kops.rowsumsq(x, keep) if use_kernels else _sumsq_tail(x, keep)


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """(B, S) accumulator: the paper's §4 factorization at token
    granularity, where it is exact for every dense layer of a sequence
    model — token t's contribution to ``∂L/∂W`` is the rank-1 outer
    product ``h_t z̄_tᵀ``, so ``s_{j,t} = ‖h_{j,t}‖²·‖z̄_{j,t}‖²``. Group
    columns do not apply; every tap folds into the one (B, S) map. Each
    stat is a row-wise Σx² over (B, S) rows: one ``rowsumsq`` launch per
    operand under ``use_kernels`` (two per dense or expert tap, one per
    bias, scale or embedding tap)."""
    seq: int

    def init(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch, self.seq), dtype=_ACC_DTYPE,
                           device=device)

    def add_dense(self, acc_bar, h, zbar, group, method, use_kernels):
        if h.ndim != 3:
            raise ValueError(
                f"TokenLayout dense tap needs (B, S, p) activations, got "
                f"shape {tuple(h.shape)}; per-token factorization is only "
                f"exact when each token is one row of the matmul")
        return acc_bar + (_rowsumsq(h, 2, use_kernels)
                          * _rowsumsq(zbar, 2, use_kernels))

    def add_dense_batched(self, acc_bar, h, zbar, group, use_kernels):
        """Batched-weight dense stat at token granularity: token t's
        contribution to its example's weight slice is still the rank-1
        outer product h_t z̄_tᵀ — the §4 factorization is exact per token,
        whichever example owns the weight."""
        if h.ndim != 3:
            raise ValueError(
                f"TokenLayout dense_batched tap needs (B, S, p) "
                f"activations, got shape {tuple(h.shape)}")
        return acc_bar + (_rowsumsq(h, 2, use_kernels)
                          * _rowsumsq(zbar, 2, use_kernels))

    def add_bias(self, acc_bar, zbar, group, use_kernels):
        # token t's bias contribution is z̄_t itself
        self._check_rank(zbar, "bias_add")
        return acc_bar + _rowsumsq(zbar, 2, use_kernels)

    def add_scale(self, acc_bar, h, zbar, group, use_kernels):
        # token t's gain contribution is h_t ⊙ z̄_t
        self._check_rank(zbar, "scale")
        prod = h.to(_ACC_DTYPE) * zbar.to(_ACC_DTYPE)
        return acc_bar + _rowsumsq(prod, 2, use_kernels)

    def add_embedding(self, acc_bar, ids, zbar, group, use_kernels):
        # one-hot row ⇒ ‖h_t‖² = 1 ⇒ the stat is ‖z̄_t‖²
        self._check_rank(zbar, "embedding")
        return acc_bar + _rowsumsq(zbar, 2, use_kernels)

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
        stat = _rowsumsq(x, 2, use_kernels) * _rowsumsq(zbar, 2, use_kernels)
        valid = (tok >= 0) & (tok < b * s)
        return self._scatter_slot_stats(acc_bar, stat, tok, valid)

    def add_expert_grouped(self, acc_bar, x, zbar, seg, group, bg,
                           use_kernels, *, tok):
        """Grouped-dispatch variant: x (G,E,C,d), zbar (G,E,C,f), tok
        (G,E,C) GROUP-LOCAL flat token ids (∉ [0, bg·S) ⇒ padding slot);
        group g covers the flat tokens [g·bg·S, (g+1)·bg·S)."""
        b, s = acc_bar.shape
        ng = x.shape[0]
        tg = bg * s
        stat = _rowsumsq(x, 3, use_kernels) * _rowsumsq(zbar, 3, use_kernels)
        valid = (tok >= 0) & (tok < tg)
        glob = torch.arange(ng, device=tok.device)[:, None, None] * tg + tok
        return self._scatter_slot_stats(acc_bar, stat, glob, valid)


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
    def forward(ctx, h, w, acc, mode, layout, group, method, use_kernels):
        ctx.save_for_backward(h, w)
        ctx.cfg = (mode, layout, group, method, use_kernels)
        return torch.matmul(h, w), acc.clone()

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
        return dh, dw, dacc, None, None, None, None, None


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
                   table.dtype)
        return table[ids], acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        (ids,) = ctx.saved_tensors
        mode, layout, group, use_kernels, shape, dtype = ctx.cfg
        dtable = dacc = None
        if mode.grads and ctx.needs_input_grad[0]:
            dtable = N.add_rows(
                torch.zeros(shape, dtype=dtype, device=zbar.device),
                ids.reshape(-1), zbar.reshape(-1, shape[-1]).to(dtype))
        if mode.norms:
            dacc = layout.add_embedding(acc_bar, ids, zbar, group,
                                        use_kernels)
        return dtable, None, dacc, None, None, None, None


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
        return torch.einsum("gecd,edf->gecf", x, w), acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        x, w, seg, tok = ctx.saved_tensors
        mode, layout, group, bg, use_kernels = ctx.cfg
        dx = dw = dacc = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("gecf,edf->gecd", zbar, w).to(x.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dw = torch.einsum("gecd,gecf->edf", x, zbar).to(w.dtype)
        if mode.norms:
            dacc = layout.add_expert_grouped(acc_bar, x, zbar, seg, group,
                                             bg, use_kernels, tok=tok)
        return dx, dw, None, None, dacc, None, None, None, None, None


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
        """Instrumented matmul. Plain matmul when the tap is inert."""
        if not self.live:
            return torch.matmul(h, w)
        z, self._acc = _Dense.apply(
            h, w, self._acc, self.mode, self.layout,
            self.spec.group_index(group), method or self.spec.method,
            self.spec.use_kernels)
        return z

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
        z, self._acc = _DenseBatched.apply(
            h, w, self._acc, self.mode, self.layout,
            self.spec.group_index(group), self.spec.use_kernels)
        return z

    def bias_add(self, x, b, *, group: str = "all") -> torch.Tensor:
        if not self.live:
            return x + b
        z, self._acc = _Bias.apply(x, b, self._acc, self.mode, self.layout,
                                   self.spec.group_index(group),
                                   self.spec.use_kernels)
        return z

    def scale(self, h, g, *, group: str = "all") -> torch.Tensor:
        if not self.live:
            return h * g
        z, self._acc = _Scale.apply(h, g, self._acc, self.mode, self.layout,
                                    self.spec.group_index(group),
                                    self.spec.use_kernels)
        return z

    def embedding(self, table, ids, *, group: str = "embed") -> torch.Tensor:
        if not (self.live and self.spec.tap_embeddings):
            return table[ids]
        z, self._acc = _Embed.apply(table, ids, self._acc, self.mode,
                                    self.layout,
                                    self.spec.group_index(group),
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
        z, self._acc = _DenseExpert.apply(
            x, w, seg, tok, self._acc, self.mode, self.layout,
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
        return self.dense_expert_grouped(x[None], w, seg[None],
                                         self._acc.shape[0], tok[None],
                                         group=group)[0]


#: Shared inert tap: every op is its plain counterpart.
NULL = Tap(DISABLED)
