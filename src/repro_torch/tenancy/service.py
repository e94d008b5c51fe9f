"""Multi-tenant LoRA fine-tuning service (DESIGN.md §14).

Port of ``src/repro/tenancy/service.py``. One ``TenantService.step`` takes
an interleaved mixed-tenant batch and runs everything in one fused pass,
however many tenants share the batch:

  1. ``tenancy.batch.assemble`` sorts examples by tenant (tenant =
     segment; the segmented estimator sees sorted runs);
  2. the per-batch active adapter set is gathered from the
     ``AdapterStore`` — the Engine's *params* are exactly those rows, so
     the scatter-add of the per-example gather's backward IS the
     per-tenant gradient reduction (``core.norms.add_rows``: the same
     bits on every run, where ``index_select``'s own backward adds by
     atomics on CUDA);
  3. the loss closure expands rows to per-example adapter slices (by the
     batch's ``tenant_index``) and calls the user loss; the LoRA factors
     go through ``tap.dense_batched``, so one segmented launch per factor
     computes per-example norms across all tenants;
  4. ``Clip(C)`` clips per example inside the fused pass;
     ``Noise(σ, rng, segments=tenant_ids)`` gives each tenant noise of its
     own, from a generator derived from the step's seed and its id — each
     tenant's DP accounting is independent of who else shares the batch;
  5. SGD on the active rows, scattered back into the store.

Between steps the service admits queued tenants into free slots and
evicts on request (the serve engine's slot-recycling idiom).

``mesh=`` (a ``DeviceMesh``) runs the step data-parallel through
``dist.pex`` over ``data_axes``: the sorted batch's rows, its
``tenant_index`` among them, are split over the ranks with the examples,
the per-tenant gradient sums are all-reduced, and every rank adds the same
per-tenant noise and applies the same update to its copy of the store.

``ckpt_manager=`` (a ``ckpt.CheckpointManager``) lets ``save`` and
``restore`` checkpoint the store's resident tenants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import Engine
from repro_torch.core.norms import add_rows
from repro_torch.core.taps import PexSpec
from repro_torch.nn.param import tree_map
from repro_torch.tenancy import batch as tbatch
from repro_torch.tenancy.adapters import AdapterStore


class _GatherRows(torch.autograd.Function):
    """``v.index_select(0, idx)`` whose backward adds each index's rows in
    the same order on every run (``core.norms.add_rows``; on the CPU the
    bits of ``index_select``'s own backward)."""

    @staticmethod
    def forward(ctx, v, idx):
        ctx.save_for_backward(idx)
        ctx.rows = v.shape[0]
        return v.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        return add_rows(out, idx, g), None


@dataclasses.dataclass(frozen=True)
class TenantStepResult:
    """One service step's outputs, per-tenant views included."""
    loss: torch.Tensor                    # scalar Σ over the batch
    loss_vec: torch.Tensor                # (B,) sorted-example losses
    sq_norms: Any                         # (B, G) or (B, S) accumulator
    clip_coef: Optional[torch.Tensor]     # per-example (or -token) c_j
    tenant_ids: np.ndarray                # (T,) tenants in this batch
    tenant_loss: torch.Tensor             # (T,) Σ loss per tenant
    tenant_count: torch.Tensor            # (T,) examples per tenant
    tenant_clip_mean: Optional[torch.Tensor]  # (T,) mean clip coefficient
    tenant_clip_min: Optional[torch.Tensor]   # (T,) min clip coefficient
    aux: Any = None


class TenantService:
    """Elastic multi-tenant fine-tuning over one ``AdapterStore``.

    loss_fn:   ``(per_example_adapters, data_batch, tap) -> (loss_vec,
               aux)`` — per_example_adapters is the adapter tree with a
               leading (B,) axis (example j's row is its tenant's state);
               route its factors through ``tap.dense_batched``
               (``nn.linear.linear`` does, for trees of LoRA sites).
    store:     the ``AdapterStore`` holding resident tenants.
    clip_norm: per-example clip threshold C.
    noise_std: DP noise multiplier σ (0 disables noise).
    noise_scale: explicit sensitivity (required at token granularity,
               where C does not bound an example's total contribution).
    lr:        SGD learning rate applied to the active rows.
    mesh:      a ``DeviceMesh`` (every rank holds the same store) or None.
    ckpt_manager: a ``ckpt.CheckpointManager`` for ``save``/``restore``.
    """

    def __init__(self, store: AdapterStore, loss_fn: Callable, *,
                 clip_norm: float, noise_std: float = 0.0,
                 noise_scale: Optional[float] = None, lr: float = 0.1,
                 spec: Optional[PexSpec] = None, mesh=None,
                 data_axes: Sequence[str] = ("data",),
                 granularity: str = "example", ckpt_manager=None):
        self.store = store
        self.loss_fn = loss_fn
        self.clip_norm = float(clip_norm)
        self.noise_std = float(noise_std)
        self.noise_scale = noise_scale
        self.lr = float(lr)
        self.granularity = granularity
        self.engine = Engine(spec, mesh=mesh, data_axes=data_axes,
                             granularity=granularity)
        self.ckpt_manager = ckpt_manager
        self.pending: list = []
        self.steps_run = 0

    # -- admission (serve/engine.py slot recycling) -----------------------
    def submit(self, *tenant_ids) -> None:
        """Queue tenants for admission at the next step boundary."""
        for t in tenant_ids:
            if not self.store.has(t) and int(t) not in self.pending:
                self.pending.append(int(t))

    def admit_pending(self) -> Sequence[int]:
        """Admit queued tenants into the free slots (head of the queue
        first; the rest wait)."""
        active = self.pending[:self.store.n_free]
        self.pending = self.pending[len(active):]
        for t in active:
            self.store.admit(t)
        return active

    def evict(self, tenant_id: int) -> None:
        self.store.evict(tenant_id)

    # -- the fused step ----------------------------------------------------
    def consumers(self, tb: tbatch.TenantBatch, rng=None) -> list:
        """The plan for one mixed-tenant step: per-example Clip, and — when
        σ > 0 — per-tenant segmented Noise."""
        cons = [plan_mod.Clip(self.clip_norm, granularity=self.granularity)]
        if self.noise_std > 0.0:
            scale = self.noise_scale
            if scale is None:
                if self.granularity == "token":
                    raise ValueError(
                        "token-granularity DP needs an explicit "
                        "noise_scale: per-token clipping bounds each "
                        "token term by C, not the example total")
                scale = self.clip_norm
            cons.append(plan_mod.Noise(self.noise_std, rng, scale=scale,
                                       segments=tb.segments()))
        return cons

    def _closure(self):
        loss_fn = self.loss_fn

        def loss(adapters, eb, tap):
            idx = eb["tenant_index"]
            per_ex = tree_map(lambda v: _GatherRows.apply(v, idx),
                              adapters)
            data = {k: v for k, v in eb.items() if k != "tenant_index"}
            if tuple(data) == ("data",):
                data = data["data"]
            return loss_fn(per_ex, data, tap)

        return loss

    def step(self, batch, tenant_ids, *, rng=None,
             apply_updates: bool = True,
             seq: Optional[int] = None) -> TenantStepResult:
        """One fused mixed-tenant DP step. ``batch`` is any (B, ...) tree;
        ``tenant_ids`` (B,) owners per example; ``rng`` a
        ``torch.Generator`` on the store's device (needed when σ > 0).
        Unknown tenants are admitted on demand (after the pending queue
        drains)."""
        if self.noise_std > 0.0 and rng is None:
            raise ValueError("noise_std > 0 needs rng= (the step's "
                             "generator; tenant generators derive from it)")
        self.admit_pending()
        tb = tbatch.assemble(batch, tenant_ids)
        for t in tb.unique_tenants:
            self.store.admit(int(t))
        active = self.store.gather(tb.unique_tenants)

        res = self.engine.step(self._closure(), active, tb.batch,
                               self.consumers(tb, rng), seq=seq)
        if apply_updates:
            updated = tree_map(lambda a, g: a - self.lr * g.to(a.dtype),
                               active, res.grads)
            self.store.scatter(tb.unique_tenants, updated)
        self.steps_run += 1

        t_idx, n_t = tb.tenant_index, tb.n_tenants
        cc = res.clip_coef
        per_ex_cc = cc if cc is not None and cc.ndim == 1 else None
        return TenantStepResult(
            loss=res.loss, loss_vec=res.loss_vec, sq_norms=res.sq_norms,
            clip_coef=cc, tenant_ids=tb.unique_tenants,
            tenant_loss=tbatch.per_tenant_sum(
                res.loss_vec.to(torch.float32), t_idx, n_t),
            tenant_count=tbatch.per_tenant_count(t_idx, n_t),
            tenant_clip_mean=None if per_ex_cc is None
            else tbatch.per_tenant_mean(per_ex_cc, t_idx, n_t),
            tenant_clip_min=None if per_ex_cc is None
            else tbatch.per_tenant_min(per_ex_cc, t_idx, n_t),
            aux=res.aux)

    # -- checkpointing -----------------------------------------------------
    def save(self, step: Optional[int] = None, *, block: bool = True):
        if self.ckpt_manager is None:
            raise ValueError("construct the service with ckpt_manager= "
                             "to checkpoint")
        self.store.save(self.ckpt_manager,
                        self.steps_run if step is None else step,
                        block=block)

    def restore(self, step: Optional[int] = None) -> Sequence[int]:
        if self.ckpt_manager is None:
            raise ValueError("construct the service with ckpt_manager= "
                             "to restore")
        return self.store.restore(self.ckpt_manager, step)
