"""Supervised recovery: the state machine that closes the
fault-tolerance loop (DESIGN.md §11).

Port of ``src/repro/ft/supervisor.py`` (host logic, the same code).

``ft/heartbeat.py`` detects, ``ft/elastic.py`` plans, ``ckpt/``
restores — but until this module nothing *drove* them through a
failure. The ``Supervisor`` consumes heartbeat surveys and per-host
step times every tick and, when something is wrong, executes one
recovery transition:

    RUNNING ──(dead host / evicted straggler)──▶ RECOVERING(contract)
    RUNNING ──(persistent straggler < grace)───▶ DEGRADED (observe)
    RUNNING ──(fresh spare hosts, bigger pow2)─▶ RECOVERING(expand)
    RECOVERING ──(restored + resharded + renumbered)──▶ RUNNING
    any ──(plan_contraction impossible / no restorable ckpt)─▶ HALTED

Contraction and expansion share one recovery path: plan the new
topology (``plan_contraction`` / ``plan_expansion``), pick the new
active host set (``reassign_data_hosts`` — survivors renumbered into
the contracted data layout, order-preserving), then hand the plan to a
``RecoveryActions`` implementation that restores the latest valid
checkpoint resharded onto the new topology, renumbers the
data-pipeline hosts, and resumes the Trainer. The split keeps the
machine unit-testable (feed it a fake actions object) and keeps
cluster mechanics (meshes, shard assignment, jit rebinding) out of the
policy — ``launch/soak.py`` provides the real actions for the
simulated world.

Straggler policy: a straggler is *observed* (DEGRADED) for
``straggler_grace`` consecutive detections before it is evicted
through the contraction path — transient slowness (GC pause, noisy
neighbor) must not trigger a reshard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.ft import elastic
from repro_torch.ft.heartbeat import HeartbeatMonitor, detect_stragglers

RUNNING = "RUNNING"
DEGRADED = "DEGRADED"
RECOVERING = "RECOVERING"
HALTED = "HALTED"


class SupervisorHalted(RuntimeError):
    """The world is unrecoverable: contraction below the
    model-parallel floor, or no restorable checkpoint."""


@dataclasses.dataclass
class SupervisorConfig:
    #: consecutive straggler detections before eviction
    straggler_grace: int = 3
    straggler_mad_factor: float = 3.0
    #: allow growing back when spare/returned hosts heartbeat
    allow_expansion: bool = True


@dataclasses.dataclass
class RecoveryEvent:
    now: float
    kind: str           # dead / straggler / evict / contract / expand / halt
    detail: Dict


class RecoveryActions:
    """What a recovery transition must do to the world. Implementors:
    ``launch/soak.py`` (simulated cluster); a real launcher would
    restart processes here."""

    def restore_to(self, topology: elastic.Topology,
                   active_hosts: Sequence[int], reason: str) -> None:
        """Restore the latest valid checkpoint resharded to
        ``topology`` over ``active_hosts``, renumber the data pipeline,
        and resume the trainer. ``reason`` ∈ {contract, evict, expand}.
        Must raise on an unrecoverable world (propagates to HALTED)."""
        raise NotImplementedError


class Supervisor:
    def __init__(self, topo: elastic.Topology,
                 active_hosts: Sequence[int],
                 monitor: HeartbeatMonitor,
                 actions: RecoveryActions,
                 cfg: Optional[SupervisorConfig] = None):
        assert topo.n_hosts == len(active_hosts), \
            f"topology says {topo.n_hosts} hosts, active set has " \
            f"{len(active_hosts)}"
        self.topo = topo
        self.active: List[int] = sorted(active_hosts)
        self.monitor = monitor
        self.actions = actions
        self.cfg = cfg or SupervisorConfig()
        self.state = RUNNING
        self.events: List[RecoveryEvent] = []
        self._straggler_count: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def _log(self, now: float, kind: str, **detail) -> RecoveryEvent:
        ev = RecoveryEvent(now, kind, detail)
        self.events.append(ev)
        return ev

    def _recover(self, now: float, new_topo: elastic.Topology,
                 new_active: List[int], reason: str) -> None:
        self.state = RECOVERING
        try:
            self.actions.restore_to(new_topo, new_active, reason)
        except Exception as e:
            self.state = HALTED
            self._log(now, "halt", reason=f"{reason} failed: {e}")
            raise SupervisorHalted(str(e)) from e
        self.topo = new_topo
        self.active = sorted(new_active)
        self._straggler_count.clear()
        self.state = RUNNING
        self._log(now, reason, topology=dataclasses.asdict(new_topo),
                  active=list(self.active))

    def _contract(self, now: float, dead: List[int], reason: str) -> None:
        try:
            new_topo = elastic.plan_contraction(self.topo, dead)
        except RuntimeError as e:
            self.state = HALTED
            self._log(now, "halt", reason=str(e))
            raise SupervisorHalted(str(e)) from e
        new_active = elastic.reassign_data_hosts(self.active, dead,
                                                 new_topo.n_hosts)
        self._recover(now, new_topo, new_active, reason)

    # ------------------------------------------------------------------
    def tick(self, now: float,
             step_times: Optional[Dict[int, float]] = None)\
            -> List[RecoveryEvent]:
        """One supervision round. Returns the events this tick
        generated; mutates the world through ``actions`` when a
        recovery runs. Raises ``SupervisorHalted`` when unrecoverable."""
        if self.state == HALTED:
            raise SupervisorHalted("supervisor already halted")
        n_before = len(self.events)
        survey = self.monitor.survey(now)

        # -- death detection (scoped to the active set: dropped-idle
        # hosts go heartbeat-silent by design and are not failures) --
        dead = [h for h in self.active
                if h not in survey or not survey[h].get("alive")]
        if dead:
            for h in dead:
                self._log(now, "dead", host=h,
                          error=survey.get(h, {}).get("error"))
            self._contract(now, dead, "contract")
            return self.events[n_before:]

        # -- straggler grace/eviction --
        if step_times:
            active_times = {h: t for h, t in step_times.items()
                            if h in self.active}
            slow = detect_stragglers(active_times,
                                     self.cfg.straggler_mad_factor)
            for h in list(self._straggler_count):
                if h not in slow:
                    del self._straggler_count[h]
            evicted = None
            for h in slow:
                self._straggler_count[h] = self._straggler_count.get(h, 0) + 1
                self._log(now, "straggler", host=h,
                          consecutive=self._straggler_count[h],
                          step_time=active_times[h])
                if self._straggler_count[h] >= self.cfg.straggler_grace \
                        and evicted is None:
                    evicted = h
            if evicted is not None:
                self._log(now, "evict", host=evicted)
                self._contract(now, [evicted], "evict")
                return self.events[n_before:]
            self.state = DEGRADED if slow else RUNNING

        # -- expansion: fresh heartbeats from non-active hosts --
        if self.cfg.allow_expansion:
            fresh = [h for h, p in survey.items()
                     if p.get("alive") and h not in self.active]
            if fresh:
                pool = sorted(set(self.active) | set(fresh))
                new_topo = elastic.plan_expansion(self.topo, len(pool))
                if new_topo.n_hosts > len(self.active):
                    self._log(now, "returned", hosts=sorted(fresh))
                    self._recover(now, new_topo,
                                  pool[:new_topo.n_hosts], "expand")
        return self.events[n_before:]
