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

The MoE expert ops (``dense_expert``, ``dense_expert_grouped``) take their
stat from the segmented estimator over (group, expert, example) composite
segments, all groups in one launch.

Not in this slice: ``TokenLayout`` (token granularity, and with it the
expert ops' slot → token table ``tok``), ``dense_batched``, the provenance
table for the static analyzer, and ``scan`` / ``checkpoint`` (the port
runs layers in a Python loop without recompute). ``dist.sharding.shard``
constraints are dropped: they are identities off a TPU mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import norms as N

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
                 oracle without it.
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

    def add_bias(self, acc_bar, zbar, group):
        return self.add_example_stat(acc_bar, N.stat_bias(zbar), group)

    def add_scale(self, acc_bar, h, zbar, group):
        return self.add_example_stat(acc_bar, N.stat_elementwise(h, zbar),
                                     group)

    def add_embedding(self, acc_bar, ids, zbar, group):
        stat = N.stat_embedding(ids.reshape(ids.shape[0], -1),
                                zbar.reshape(zbar.shape[0], -1,
                                             zbar.shape[-1]))
        return self.add_example_stat(acc_bar, stat, group)

    def add_expert(self, acc_bar, x, zbar, seg, group, use_kernels):
        """MoE expert-buffer stat: x (E,C,d), zbar (E,C,f), seg (E,C)
        example ids (≥ batch ⇒ padding row): the grouped stat with one
        group of the whole batch."""
        return self.add_expert_grouped(acc_bar, x[None], zbar[None],
                                       seg[None], group, acc_bar.shape[0],
                                       use_kernels)

    def add_expert_grouped(self, acc_bar, x, zbar, seg, group, bg,
                           use_kernels):
        """Grouped (GShard-local) expert stat: x (G,E,C,d), zbar
        (G,E,C,f), seg (G,E,C) GROUP-LOCAL example ids (≥ bg ⇒ padding
        row); group g's stats land at acc rows [g·bg, (g+1)·bg).

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


class _Bias(torch.autograd.Function):
    """z = x + b."""

    @staticmethod
    def forward(ctx, x, b, acc, mode, layout, group):
        ctx.cfg = (mode, layout, group)
        return x + b, acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        mode, layout, group = ctx.cfg
        db = dacc = None
        if mode.grads and ctx.needs_input_grad[1]:
            db = _lead_sum(zbar)
        if mode.norms:
            dacc = layout.add_bias(acc_bar, zbar, group)
        return zbar, db, dacc, None, None, None


class _Scale(torch.autograd.Function):
    """z = g ⊙ h (elementwise params: RMSNorm gains)."""

    @staticmethod
    def forward(ctx, h, g, acc, mode, layout, group):
        ctx.save_for_backward(h, g)
        ctx.cfg = (mode, layout, group)
        return h * g, acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        h, g = ctx.saved_tensors
        mode, layout, group = ctx.cfg
        dh = dg = dacc = None
        if ctx.needs_input_grad[0]:
            dh = (zbar * g).to(h.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dg = _lead_sum(zbar * h).to(g.dtype)
        if mode.norms:
            dacc = layout.add_scale(acc_bar, h, zbar, group)
        return dh, dg, dacc, None, None, None


class _Embed(torch.autograd.Function):
    """z = table[ids]; dtable by ``index_add_``."""

    @staticmethod
    def forward(ctx, table, ids, acc, mode, layout, group):
        ctx.save_for_backward(ids)
        ctx.cfg = (mode, layout, group, table.shape, table.dtype)
        return table[ids], acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        (ids,) = ctx.saved_tensors
        mode, layout, group, shape, dtype = ctx.cfg
        dtable = dacc = None
        if mode.grads and ctx.needs_input_grad[0]:
            dtable = torch.zeros(shape, dtype=dtype, device=zbar.device)
            dtable.index_add_(0, ids.reshape(-1),
                              zbar.reshape(-1, shape[-1]).to(dtype))
        if mode.norms:
            dacc = layout.add_embedding(acc_bar, ids, zbar, group)
        return dtable, None, dacc, None, None, None


class _DenseExpert(torch.autograd.Function):
    """z = einsum('gecd,edf->gecf', x, w): the grouped MoE expert matmul
    over the (G, E, C) capacity buffer; seg (G,E,C) holds each row's
    group-local example id (≥ bg ⇒ padding row)."""

    @staticmethod
    def forward(ctx, x, w, seg, acc, mode, layout, group, bg, use_kernels):
        ctx.save_for_backward(x, w, seg)
        ctx.cfg = (mode, layout, group, bg, use_kernels)
        return torch.einsum("gecd,edf->gecf", x, w), acc.clone()

    @staticmethod
    def backward(ctx, zbar, acc_bar):
        x, w, seg = ctx.saved_tensors
        mode, layout, group, bg, use_kernels = ctx.cfg
        dx = dw = dacc = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("gecf,edf->gecd", zbar, w).to(x.dtype)
        if mode.grads and ctx.needs_input_grad[1]:
            dw = torch.einsum("gecd,gecf->edf", x, zbar).to(w.dtype)
        if mode.norms:
            dacc = layout.add_expert_grouped(acc_bar, x, zbar, seg, group,
                                             bg, use_kernels)
        return dx, dw, None, dacc, None, None, None, None, None


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

    def bias_add(self, x, b, *, group: str = "all") -> torch.Tensor:
        if not self.live:
            return x + b
        z, self._acc = _Bias.apply(x, b, self._acc, self.mode, self.layout,
                                   self.spec.group_index(group))
        return z

    def scale(self, h, g, *, group: str = "all") -> torch.Tensor:
        if not self.live:
            return h * g
        z, self._acc = _Scale.apply(h, g, self._acc, self.mode, self.layout,
                                    self.spec.group_index(group))
        return z

    def embedding(self, table, ids, *, group: str = "embed") -> torch.Tensor:
        if not (self.live and self.spec.tap_embeddings):
            return table[ids]
        z, self._acc = _Embed.apply(table, ids, self._acc, self.mode,
                                    self.layout,
                                    self.spec.group_index(group))
        return z

    def dense_expert_grouped(self, x, w, seg, bg: int, *,
                             group: str = "moe") -> torch.Tensor:
        """Grouped instrumented expert matmul. x (G,E,C,d), w (E,d,f),
        seg (G,E,C) group-local example ids (≥ bg ⇒ padding row, excluded
        from the stats)."""
        if not self.live:
            return torch.einsum("gecd,edf->gecf", x, w)
        z, self._acc = _DenseExpert.apply(
            x, w, seg, self._acc, self.mode, self.layout,
            self.spec.group_index(group), bg, self.spec.use_kernels)
        return z

    def dense_expert(self, x, w, seg, *, group: str = "moe") -> torch.Tensor:
        """Instrumented per-expert matmul. x (E,C,d), w (E,d,f), seg (E,C)
        example ids (≥ batch ⇒ padding row): the grouped op with one group
        of the whole batch."""
        if not self.live:
            return torch.einsum("ecd,edf->ecf", x, w)
        return self.dense_expert_grouped(x[None], w, seg[None],
                                         self._acc.shape[0], group=group)[0]


#: Shared inert tap: every op is its plain counterpart.
NULL = Tap(DISABLED)
