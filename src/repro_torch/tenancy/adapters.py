"""Per-tenant adapter store: thousands of LoRA states stacked on a tenant
axis (DESIGN.md §14).

Port of ``src/repro/tenancy/adapters.py``. Every leaf of the single-tenant
adapter tree (typically a dict of ``nn.lora.LoraPair``s) is stored stacked
as ``(capacity, ...)`` on one device; a host-side slot table maps tenant
id → row. Admission writes a deterministic fresh state (``init_fn`` gets a
generator seeded with ``fold_seed(seed, tenant_id)``, so a re-admitted
tenant that was never trained restarts bit for bit), eviction frees and
zeroes the row, and ``gather``/``scatter`` move the per-batch active set
in and out as one gather and one indexed write per leaf. Rows are
written in place. ``save`` writes the compacted active set through a
``ckpt.CheckpointManager``; ``restore`` repacks it into slots ``[0..n)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.nn.param import (AXES_ATTR, box, fold_seed,
                                  resolve_device, tree_leaves, tree_map)

class AdapterStore:
    """Slot-allocated stacked store of per-tenant adapter trees.

    init_fn:  ``generator -> adapter tree`` (single-tenant shapes, on the
              generator's device). Called once at construction for shapes,
              and per admission with the tenant's generator.
    capacity: max resident tenants (slot count).
    seed:     master seed; tenant t's generator is seeded with
              ``fold_seed(seed, t)``.
    device:   where the rows live (default CUDA).
    """

    def __init__(self, init_fn: Callable, capacity: int, seed: int,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.init_fn = init_fn
        self.capacity = int(capacity)
        self.seed = int(seed)
        self.device = resolve_device(device)
        template = init_fn(self._generator(self.seed))
        # each row's leaf keeps its template's logical axes, the tenant
        # axis replicated
        self.stacked = tree_map(
            lambda l: box(torch.zeros((self.capacity,) + tuple(l.shape),
                                      dtype=l.dtype, device=self.device),
                          (None,) + getattr(l, AXES_ATTR,
                                            (None,) * l.ndim)),
            template)
        self.slots = np.full((self.capacity,), -1, dtype=np.int64)
        self._slot_of: dict = {}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- bookkeeping -----------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    @property
    def n_free(self) -> int:
        return self.capacity - self.n_active

    @property
    def tenants(self) -> np.ndarray:
        """Sorted ids of resident tenants."""
        return np.array(sorted(self._slot_of), dtype=np.int64)

    def has(self, tenant_id: int) -> bool:
        return int(tenant_id) in self._slot_of

    def slot_of(self, tenant_id: int) -> int:
        return self._slot_of[int(tenant_id)]

    # -- admission / eviction (the serve engine's slot recycling) --------
    def admit(self, tenant_id: int) -> int:
        """Ensure ``tenant_id`` is resident; returns its slot. A fresh
        admission initializes the row from the tenant's generator."""
        tid = int(tenant_id)
        if tid < 0:
            raise ValueError(f"tenant ids must be non-negative, got {tid}")
        if tid in self._slot_of:
            return self._slot_of[tid]
        free = np.flatnonzero(self.slots < 0)
        if free.size == 0:
            raise RuntimeError(
                f"adapter store is full ({self.capacity} slots); evict a "
                f"tenant before admitting {tid}")
        slot = int(free[0])
        state = self.init_fn(self._generator(fold_seed(self.seed, tid)))
        for s, l in zip(tree_leaves(self.stacked), tree_leaves(state)):
            s[slot] = l.to(s.dtype)
        self.slots[slot] = tid
        self._slot_of[tid] = slot
        return slot

    def evict(self, tenant_id: int) -> None:
        """Free the tenant's slot (its state is dropped)."""
        tid = int(tenant_id)
        slot = self._slot_of.pop(tid, None)
        if slot is None:
            return
        self.slots[slot] = -1
        # zero the row so freed state never leaks into a later gather
        for s in tree_leaves(self.stacked):
            s[slot] = 0

    # -- batch movement ---------------------------------------------------
    def _rows(self, tenant_ids) -> torch.Tensor:
        rows = []
        for t in np.asarray(tenant_ids).reshape(-1):
            slot = self._slot_of.get(int(t))
            if slot is None:
                raise KeyError(f"tenant {int(t)} is not resident; admit() "
                               f"it first")
            rows.append(slot)
        return torch.as_tensor(rows, dtype=torch.int64, device=self.device)

    def gather(self, tenant_ids):
        """Adapter tree with rows for ``tenant_ids`` stacked leading — the
        per-batch active set the Engine trains (a copy)."""
        rows = self._rows(tenant_ids)
        return tree_map(lambda s: s.index_select(0, rows), self.stacked)

    def scatter(self, tenant_ids, tree) -> None:
        """Write updated rows back (inverse of :meth:`gather`)."""
        rows = self._rows(tenant_ids)
        for s, v in zip(tree_leaves(self.stacked), tree_leaves(tree)):
            s[rows] = v.to(s.dtype)

    # -- checkpointing ----------------------------------------------------
    def save(self, manager, step: int, *, block: bool = True) -> None:
        """Write the compacted active set (rows in tenant-id order) via
        ``ckpt.CheckpointManager``; the tenant list rides in the manifest
        ``extra``."""
        tenants = self.tenants
        compact = self.gather(tenants)
        manager.save(step, compact, extra={
            "tenancy": {"tenants": [int(t) for t in tenants]}},
            block=block)

    def restore(self, manager, step: Optional[int] = None) -> Sequence[int]:
        """Load a checkpoint and repack its tenants into slots ``[0..n)`` in
        tenant-id order (renumbering — bit-exact per tenant), in place.
        Leaf shapes come from the manifest, dtypes from the store. Returns
        the restored tenant ids."""
        if step is None:
            step = manager.latest_step()
        compact, extra = manager.restore(step, self.stacked,
                                         device=self.device)
        tenants = [int(t) for t in extra["tenancy"]["tenants"]]
        n = len(tenants)
        if n > self.capacity:
            raise ValueError(
                f"checkpoint holds {n} tenants but the store has only "
                f"{self.capacity} slots; restore into a larger store")
        self.slots = np.full((self.capacity,), -1, dtype=np.int64)
        self._slot_of = {}
        # compact leaves arrive shaped (n, ...) from the manifest
        for s, c in zip(tree_leaves(self.stacked), tree_leaves(compact)):
            s.zero_()
            s[:n] = c
        for i, t in enumerate(tenants):
            self.slots[i] = t
            self._slot_of[t] = i
        return tenants
