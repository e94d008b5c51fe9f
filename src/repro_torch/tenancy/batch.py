"""Mixed-tenant batch assembly — tenant = segment (DESIGN.md §14).

Port of ``src/repro/tenancy/batch.py``. A serving step receives examples
from many tenants interleaved. ``assemble`` sorts them by tenant id (a
stable argsort on the host, the gather on the batch's device) so that:

  * each tenant's examples are one contiguous run: the ``dense_batched``
    tap flattens tokens and runs the segmented estimator with example ids
    as segments, so ONE launch covers every tenant in the batch;
  * the per-example → per-tenant maps (``tenant_index``,
    ``unique_tenants``, ``counts``) are run-length tables, and per-tenant
    reductions over per-example stats are segment reductions over sorted
    ids.

``tenant_index`` rides INSIDE the assembled batch dict (key
``"tenant_index"``), as in the reference, where it shards with the
examples.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.nn.param import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TenantBatch:
    """One assembled mixed-tenant batch.

    batch:          tenant-sorted batch dict with a ``tenant_index`` (B,)
                    int64 leaf added (position j's index into
                    ``unique_tenants``) — feed this to the Engine.
    tenant_ids:     (B,) sorted tenant id per example (numpy, host).
    unique_tenants: (T,) sorted distinct tenant ids in the batch.
    counts:         (T,) examples per tenant.
    perm:           (B,) sorted position i holds original example
                    ``perm[i]``.
    inv_perm:       (B,) original example j sits at sorted position
                    ``inv_perm[j]``.
    """
    batch: Any
    tenant_ids: np.ndarray
    unique_tenants: np.ndarray
    counts: np.ndarray
    perm: np.ndarray
    inv_perm: np.ndarray

    @property
    def n_tenants(self) -> int:
        return int(self.unique_tenants.shape[0])

    @property
    def batch_size(self) -> int:
        return int(self.tenant_ids.shape[0])

    @property
    def tenant_index(self) -> torch.Tensor:
        return self.batch["tenant_index"]

    def segments(self) -> torch.Tensor:
        """(T,) tenant ids on the batch's device — the ``Noise.segments``
        argument (per-tenant noise)."""
        return torch.as_tensor(self.unique_tenants, dtype=torch.int64,
                               device=self.tenant_index.device)


def assemble(batch, tenant_ids) -> TenantBatch:
    """Sort a mixed-tenant batch by tenant id (stable, on the host).

    ``batch`` is any tree of (B, ...) tensors on one device; ``tenant_ids``
    is a (B,) int array-like of the owning tenant per example. Stability
    keeps each tenant's examples in their order, so re-assembling the same
    batch is deterministic."""
    tids = np.asarray(tenant_ids.cpu() if torch.is_tensor(tenant_ids)
                      else tenant_ids)
    if tids.ndim != 1:
        raise ValueError(f"tenant_ids must be (B,), got {tids.shape}")
    if tids.size and tids.min() < 0:
        raise ValueError("tenant ids must be non-negative (negative ids "
                         "are reserved for free adapter slots)")
    perm = np.argsort(tids, kind="stable")
    sorted_ids = tids[perm]
    unique, inverse, counts = np.unique(sorted_ids, return_inverse=True,
                                        return_counts=True)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size)
    device = tree_leaves(batch)[0].device
    perm_t = torch.as_tensor(perm, device=device)
    sorted_batch = tree_map(lambda v: v.index_select(0, perm_t), batch)
    if not isinstance(sorted_batch, dict):
        sorted_batch = {"data": sorted_batch}
    if "tenant_index" in sorted_batch:
        raise ValueError("batch already carries a 'tenant_index' leaf; "
                         "assemble() owns that key")
    sorted_batch["tenant_index"] = torch.as_tensor(
        inverse.reshape(-1), dtype=torch.int64, device=device)
    return TenantBatch(sorted_batch, sorted_ids, unique, counts, perm,
                       inv_perm)


# ---------------------------------------------------------------------------
# per-tenant reductions over per-example stats (sorted segments)
# ---------------------------------------------------------------------------

def _reduce(values, tenant_index, n_tenants: int, how: str):
    """A segment reduction over sorted ``tenant_index``: one pass in a
    fixed order (no atomics), every tenant in [0, n_tenants) present."""
    lengths = torch.bincount(tenant_index, minlength=n_tenants)
    return torch.segment_reduce(values, how, lengths=lengths)


def per_tenant_sum(values, tenant_index, n_tenants: int) -> torch.Tensor:
    """Σ over each tenant's examples. ``values`` (B, ...) with sorted
    ``tenant_index``."""
    return _reduce(values, tenant_index, n_tenants, "sum")


def per_tenant_count(tenant_index, n_tenants: int) -> torch.Tensor:
    return torch.bincount(tenant_index, minlength=n_tenants)


def per_tenant_mean(values, tenant_index, n_tenants: int) -> torch.Tensor:
    s = per_tenant_sum(values.to(torch.float32), tenant_index, n_tenants)
    c = per_tenant_count(tenant_index, n_tenants).to(torch.float32)
    shape = (-1,) + (1,) * (s.ndim - 1)
    return s / torch.clamp(c.reshape(shape), min=1.0)


def per_tenant_min(values, tenant_index, n_tenants: int) -> torch.Tensor:
    return _reduce(values, tenant_index, n_tenants, "min")


def per_tenant_max(values, tenant_index, n_tenants: int) -> torch.Tensor:
    return _reduce(values, tenant_index, n_tenants, "max")
