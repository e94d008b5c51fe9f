"""Elastic scaling: recompute the mesh + data assignment after a host
set change, and reshard a checkpoint onto the new topology.

Port of ``src/repro/ft/elastic.py`` (host logic, the same code).

Strategy (contraction after failure):
  1. Drop dead hosts; keep the largest power-of-two data-axis size that
     the survivors support (model axis is fixed by the arch's TP plan).
  2. Rebuild data-pipeline host assignments (the pipeline is a pure
     function of (seed, step, host), so reassignment is just renumber).
  3. Restore the last checkpoint re-sharded to the new mesh —
     CheckpointManager.restore(shardings=new) handles placement.

Expansion (hosts return) is the same computation in reverse
(``plan_expansion``); the supervisor (ft/supervisor.py) drives both
directions through one restore-resharded-and-renumber path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    n_hosts: int
    devices_per_host: int
    model_parallel: int           # fixed by the arch sharding plan

    @property
    def n_devices(self) -> int:
        return self.n_hosts * self.devices_per_host


def _pow2_floor(n: int) -> int:
    usable = 1
    while usable * 2 <= n:
        usable *= 2
    return usable


def plan_contraction(topo: Topology, dead_hosts: List[int]) -> Topology:
    """Largest runnable topology after removing dead hosts."""
    survivors = topo.n_hosts - len(dead_hosts)
    if survivors * topo.devices_per_host < topo.model_parallel:
        raise RuntimeError("not enough devices for the model-parallel plan")
    # keep data axis a power of two for collective efficiency — but the
    # pow2 rounding must not drop below the model-parallel floor
    # (survivors=3, dph=4, mp=12 passes the raw check yet pow2(3)=2
    # hosts give only 8 devices)
    usable = _pow2_floor(survivors)
    if usable * topo.devices_per_host < topo.model_parallel:
        raise RuntimeError(
            f"survivors ({survivors} hosts) pass the raw device count but "
            f"the largest power-of-two host set ({usable}) gives "
            f"{usable * topo.devices_per_host} devices < model_parallel="
            f"{topo.model_parallel}")
    return dataclasses.replace(topo, n_hosts=usable)


def plan_expansion(topo: Topology, available_hosts: int) -> Topology:
    """Largest runnable topology on a now-available host pool — the
    reverse of ``plan_contraction``, used when hosts return after a
    failure. ``available_hosts`` counts every live host (current actives
    plus returnees); the result keeps the data axis a power of two and
    never exceeds the pool, so with the original host set back the
    original (pow2) topology is recovered exactly:
    ``plan_expansion(plan_contraction(t, dead), t.n_hosts) == t``."""
    if available_hosts < 1:
        raise RuntimeError("no hosts available to expand onto")
    usable = _pow2_floor(available_hosts)
    if usable * topo.devices_per_host < topo.model_parallel:
        raise RuntimeError(
            f"available pool ({available_hosts} hosts → pow2 {usable}) "
            f"gives {usable * topo.devices_per_host} devices < "
            f"model_parallel={topo.model_parallel}")
    return dataclasses.replace(topo, n_hosts=usable)


def mesh_shape(topo: Topology, multi_pod: bool = False) -> Tuple[int, ...]:
    data = topo.n_devices // topo.model_parallel
    if multi_pod:
        assert data % 2 == 0
        return (2, data // 2, topo.model_parallel)
    return (data, topo.model_parallel)


def reassign_data_hosts(old_hosts: List[int], dead: List[int],
                        new_count: int) -> List[int]:
    """Surviving hosts, renumbered into the contracted data layout."""
    alive = [h for h in old_hosts if h not in dead]
    return alive[:new_count]
