"""Elastic soak harness: a simulated N-host world under a fault storm.

Port of ``src/repro/launch/soak.py``:

    PYTHONPATH=src python -m repro_torch.launch.soak --hosts 4 --steps 24 \\
        --storm short --device cpu
    PYTHONPATH=src python -m repro_torch.launch.soak --hosts 4 --steps 24 \\
        --mutation-check --device cpu

Runs the per-example-norm training pipeline through a deterministic
``FaultPlan`` storm — kill a host mid-run, contract, restore, resume;
corrupt the newest checkpoint shard and watch restore fall back a step;
return the hosts and expand back — and *asserts* the three invariants that
make it a test, not a demo (DESIGN.md §11):

INV1 ``bit-exact-restore``  — after every recovery, params + optimizer
     state are byte-identical (sha256 over canonical leaf bytes) to the
     snapshot taken when the restored step was saved.
INV2 ``data-replay``        — every trained step consumes exactly the
     global batch an uninterrupted single-mesh run would have seen at that
     step, regardless of how hosts were renumbered.
INV3 ``norm-invariance``    — per-example gradient norms and the
     gradient-noise scale computed on the post-recovery mesh match the
     single-process oracle at the restored step (selfcheck tolerances:
     rtol 2e-4 on norms, 5e-3 relative on GNS).

``--mutation-check`` proves the invariants have teeth: it re-runs the storm
three times, each with one recovery guard deliberately broken (trust live
state instead of restoring / scramble the shard renumbering / compute GNS
with the local batch size), and demands that exactly the matching invariant
trips. The storm's NaN-poisoned batch must be quarantined example by example
(skip examples, not steps): the harness asserts the quarantine names
exactly the poisoned rows.

How the hosts are simulated. The reference simulates N hosts on N forced
XLA devices in one process; ``torch.distributed`` takes one process per
rank, so the port spawns **one gloo rank per simulated host** (NCCL cannot
put N ranks on one card; with ``--device cuda`` every rank runs on the
first card), joined through a ``file://`` store, as ``dist/selfcheck.py``
does. Then:

* **Every rank runs the whole deterministic world**: the fault plan, the
  supervisor and the simulated clock (one tick per attempted train step,
  heartbeats at ``now=tick``) are replicated, so every rank takes the same
  decision at the same tick. Ranks outside the active set keep ticking (and
  advance the step cursor) but skip the train step.
* **Heartbeat files go in a per-rank directory**, and each rank writes
  every beating host's heartbeat there, so the bookkeeping is local and
  cannot race across processes.
* **The checkpoint directory is shared.** The lowest active rank writes it
  (the trainer's single-writer rule) and applies the storm's checkpoint
  faults to it; the storm kills host 0, so the writer moves. The snapshot
  of each save (state digest, oracle norms and GNS) is broadcast from that
  rank to every rank. A barrier follows every commit and comes before
  every restore, and every rank restores.
* **``dist.sharding.make_mesh_over(active ranks)`` is called by every
  rank** (making a mesh's groups is collective); a rank outside it rebinds
  its trainer to no mesh.
* **INV3's oracle** is ``Engine(mesh=None)`` on the full global batch, run
  on each active rank when the step is saved.
* An invariant that trips on one rank trips on all: after each recovery's
  checks the ranks agree on the first failure (an all-reduce), so no rank
  is left waiting in a collective.

``--mutation-check`` runs its three mutants inside the same spawned group,
so the ranks start once.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import os
import pickle
import sys
import tempfile
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import ft
from repro_torch.ckpt.checkpoint import CheckpointManager, keystr, to_host
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import Engine
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import (DataConfig, LogicalShardedLM,
                                       assign_logical_shards)
from repro_torch.dist.sharding import make_mesh_over, sharding_for
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves, tree_paths
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer

INV_RESTORE = "bit-exact-restore"
INV_REPLAY = "data-replay"
INV_NORMS = "norm-invariance"

#: mutation → the invariant that must catch it (the mutation matrix)
MUTATIONS = {
    "restore": INV_RESTORE,    # keep live state instead of restoring
    "renumber": INV_REPLAY,    # scramble the shard→host renumbering
    "reshard": INV_NORMS,      # GNS with the local, not global, batch
}
#: codes the ranks agree on (an all-reduce of the largest)
_CODES = {None: 0, INV_RESTORE: 1, INV_REPLAY: 2, INV_NORMS: 3}
_TIMEOUT_S = 300              # a collective that waits longer fails


class SoakInvariantError(RuntimeError):
    def __init__(self, invariant: str, msg: str):
        super().__init__(f"[{invariant}] {msg}")
        self.invariant = invariant


class MutationCheckError(RuntimeError):
    """A disabled guard did NOT trip its invariant — the soak is asserting
    less than it claims."""


def unwrap_invariant(exc: BaseException) -> Optional[SoakInvariantError]:
    """Find the SoakInvariantError in an exception's cause chain (the
    supervisor wraps recovery failures in SupervisorHalted)."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, SoakInvariantError):
            return e
        e = e.__cause__ or e.__context__
    return None


# ---------------------------------------------------------------------------
# canonical digests (INV1 / INV2)
# ---------------------------------------------------------------------------

def tree_digest(tree) -> str:
    """sha256 over path + dtype + shape + raw bytes of every leaf, in
    canonical tree order — bit-exact equality, not allclose."""
    h = hashlib.sha256()
    for path, leaf in zip(tree_paths(tree), tree_leaves(tree)):
        raw, shape, dtype = to_host(leaf)
        h.update(keystr(path).encode())
        h.update(dtype.encode())
        h.update(repr(tuple(shape)).encode())
        h.update(raw.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class SoakConfig:
    hosts: int = 8
    steps: int = 40
    seed: int = 0
    arch: str = "llama3.2-1b"
    seq: int = 16
    batch_per_host: int = 2
    ckpt_every: int = 0           # 0 ⇒ max(2, steps // 8)
    storm: str = "short"
    workdir: Optional[str] = None
    #: "" = honest run; a MUTATIONS key disables that recovery guard
    mutate: str = ""
    verbose: bool = True
    #: "cpu", or "cuda" (every rank on the first card)
    device: str = "cpu"


class SoakWorld(ft.RecoveryActions):
    """One rank's copy of the simulated cluster: trainer + data grid +
    heartbeat files + supervisor, advanced one tick per attempted train
    step. Implements ``RecoveryActions`` so the supervisor's recovery
    transitions act on this world — and get invariant-checked while doing
    so. Every rank of the group builds one and runs it in lockstep."""

    def __init__(self, cfg: SoakConfig, plan: ft.FaultPlan, workdir: str,
                 device: torch.device):
        n = cfg.hosts
        if dist.get_world_size() != n:
            raise RuntimeError(f"need {n} ranks to simulate {n} hosts, the "
                               f"group has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.cfg = cfg
        self.plan = plan
        self.device = device
        self.mutate = cfg.mutate
        if self.mutate and self.mutate not in MUTATIONS:
            raise ValueError(f"unknown mutation {self.mutate!r}; "
                             f"have {sorted(MUTATIONS)}")
        self.n = n
        self.B = n * cfg.batch_per_host
        self.ckpt_every = cfg.ckpt_every or max(2, cfg.steps // 8)
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        hb_dir = os.path.join(workdir, f"heartbeats_rank{self.rank}")

        aspec = registry.get(cfg.arch)
        mcfg = aspec.smoke()
        params = registry.family_module(aspec).init(
            mcfg, torch.Generator(device=device).manual_seed(cfg.seed),
            device=device)
        #: poison-aware loss: batch["poison"] (all-ones normally) is a
        #: bit-exact no-op; the storm's nan_batch makes rows NaN
        self.loss = ft.poison_loss_fn(registry.make_loss_fn_v2(aspec, mcfg))
        self._consumers = (plan_mod.Norms(), plan_mod.Grads())

        data_cfg = DataConfig(vocab=mcfg.vocab, seq=cfg.seq,
                              global_batch=self.B, seed=cfg.seed)
        #: the logical shard grid is pinned at n_logical = launch hosts
        #: and NEVER changes — hosts own shard subsets (INV2's anchor)
        self.lm = LogicalShardedLM(data_cfg, n_logical=n, device=device)
        self.active: List[int] = list(range(n))
        self.owned = assign_logical_shards(n, self.active)
        #: hosts currently emitting heartbeats (killed ⇒ removed;
        #: contraction-dropped survivors go silent; host_return re-adds)
        self.beating = set(self.active)
        hb_cfg = ft.HeartbeatConfig(interval_s=1.0, deadline_s=2.5)
        self.monitors = {h: ft.HeartbeatMonitor(hb_dir, h, hb_cfg)
                         for h in range(n)}
        sup_monitor = ft.HeartbeatMonitor(hb_dir, n, hb_cfg)  # never beats

        self.trainer = Trainer(
            self.loss, params, PexSpec(enabled=True),
            adamw.AdamWConfig(lr=1e-3),
            TrainConfig(consumers=self._consumers, steps=cfg.steps,
                        log_every=0, ckpt_every=self.ckpt_every,
                        ckpt_dir=self.ckpt_dir, seed=cfg.seed),
            data_cfg, mesh=self._mesh(self.active), data=self.lm,
            device=device)
        self.supervisor = ft.Supervisor(
            ft.Topology(n_hosts=n, devices_per_host=1, model_parallel=1),
            self.active, sup_monitor, actions=self)

        #: mesh=None single-process oracle for INV3 (selfcheck's role)
        self._oracle_eng = Engine(PexSpec(enabled=True), mesh=None)

        #: step → {digest, oracle_sq, oracle_gns}, written at every save
        self.snapshots: Dict[int, Dict] = {}
        self.fallbacks = 0
        self.recoveries: List[Dict] = []
        self.fault_log: List[Dict] = []
        self.ticks = 0

    # -- helpers ----------------------------------------------------------
    def _say(self, msg: str) -> None:
        if self.cfg.verbose and self.rank == 0:
            print(f"[soak] {msg}", flush=True)

    def _mesh(self, active: Sequence[int]):
        """The data mesh over ``active`` (every rank makes it: its groups
        are made collectively); None on a rank outside it."""
        mesh = make_mesh_over(list(active), (len(active),), ("data",),
                              device_type=self.device.type)
        return mesh if self.rank in active else None

    def _agree(self, err: Optional[BaseException]) -> None:
        """Raise on every rank the worst failure any rank found (an
        invariant outranks none; a later invariant in ``_CODES`` outranks
        an earlier one), so that no rank runs on into a collective the
        others have left."""
        inv = getattr(err, "invariant", None) if err is not None else None
        code = _CODES.get(inv, 4) if err is not None else 0
        flag = torch.tensor([code], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        worst = int(flag.item())
        if not worst:
            return
        if err is not None and code == worst:
            raise err
        name = {v: k for k, v in _CODES.items()}.get(worst)
        if name is None:
            raise RuntimeError("a soak rank failed outside the invariants")
        raise SoakInvariantError(name, "tripped on another rank")

    def _state_digest(self) -> str:
        tr = self.trainer
        return tree_digest({"state": tr._state_tree(),
                            "opt_step": np.int64(int(tr.opt_state.step))})

    def _probe_batch(self, step: int):
        """The oracle/mesh probe input at ``step``: the pure logical-order
        global batch with a clean poison vector."""
        batch = dict(self.lm.global_batch_at(step))
        batch["poison"] = torch.ones(self.B, dtype=torch.float32,
                                     device=self.device)
        return batch

    def _oracle(self, params, batch):
        res = self._oracle_eng.step(self.loss, params, batch,
                                    consumers=self._consumers)
        gns = plan_mod.gradient_noise_scale(res.sq_norms, res.grads,
                                            batch_size=self.B)
        return res.sq_norms, gns

    def _save_snapshot(self) -> None:
        """Checkpoint + record the INV1/INV3 ground truth for this step: the
        state digest and the single-process oracle (norms, GNS), taken by
        the active ranks and broadcast from the writer to every rank."""
        tr = self.trainer
        snap = None
        if self.rank in self.active:
            sq, gns = self._oracle(tr.params, self._probe_batch(tr.step))
            snap = {"digest": self._state_digest(),
                    "oracle_sq": sq.float().cpu().numpy(),
                    "oracle_gns": float(gns)}
            tr.save_checkpoint()    # the writer commits; barrier on the mesh
        box = [snap]
        dist.broadcast_object_list(box, src=min(self.active))
        self.snapshots[tr.step] = box[0]

    # -- fault application ------------------------------------------------
    def _apply_fault(self, e: ft.FaultEvent, tick: int) -> None:
        tr = self.trainer
        self.fault_log.append({"tick": tick, "kind": e.kind})
        if e.kind == "host_death":
            self._say(f"tick {tick}: KILL host {e.host}")
            self.beating.discard(e.host)
        elif e.kind == "host_return":
            self._say(f"tick {tick}: hosts {sorted(e.hosts)} return")
            self.beating |= set(e.hosts)
        elif e.kind in ("ckpt_corrupt", "ckpt_truncate", "tmp_litter"):
            # the shared directory is hit once, by the writer
            if self.rank == min(self.active):
                tr.ckpt.wait()      # corrupt the *committed* newest
                if e.kind == "tmp_litter":
                    # a far-future step number: real saves never reuse the
                    # dir, so the litter survives until a manager sweeps it
                    path = ft.litter_tmp_dir(self.ckpt_dir,
                                             step=tr.step + 1_000_000)
                    self._say(f"tick {tick}: tmp litter "
                              f"{os.path.basename(path)}")
                else:
                    step = ft.corrupt_newest_checkpoint(
                        self.ckpt_dir, truncate=(e.kind == "ckpt_truncate"))
                    self._say(f"tick {tick}: {e.kind} step {step}")
            dist.barrier()
        # "straggler" needs no world mutation: it enters through the
        # per-host step times fed to the supervisor each tick

    # -- RecoveryActions --------------------------------------------------
    def restore_to(self, topology: ft.Topology, active_hosts, reason: str
                   ) -> None:
        tr = self.trainer
        active = sorted(active_hosts)
        self._say(f"recovery[{reason}] → {len(active)} hosts {active}")
        tr.ckpt.wait()              # surface async writer failures now
        if reason == "expand":
            # a healthy world checkpoints before resharding wider so
            # expansion never costs progress
            self._save_snapshot()
        dist.barrier()              # every commit lands before a restore
        # the recovered world restarts its checkpoint manager — which must
        # sweep any crashed-mid-save .tmp litter on construction; its
        # writer sweeps before the others look
        if self.rank == active[0]:
            tr.ckpt = CheckpointManager(self.ckpt_dir)
        dist.barrier()
        if self.rank != active[0]:
            tr.ckpt = CheckpointManager(self.ckpt_dir)
        leftover = [f for f in os.listdir(self.ckpt_dir)
                    if f.endswith(".tmp")]
        if leftover:
            raise RuntimeError(f"stale tmp litter survived manager "
                               f"construction: {leftover}")

        live = (tr.params, tr.opt_state)
        newest = tr.ckpt.latest_step()
        mesh = self._mesh(active)
        if mesh is None:
            tr.rebind_mesh(None)
            restored = tr.restore_from(None)
        else:
            restored = tr.restore_from(None, shardings=sharding_for((),
                                                                    mesh))
        if self.mutate == "restore":
            # MUTATION: trust the live in-memory state instead of the
            # checkpoint (a supervisor that "resumes" without restoring)
            tr.params, tr.opt_state = live

        # INV1 — bit-exact restore
        snap = self.snapshots.get(restored)
        if snap is None:
            raise RuntimeError(f"restored step {restored} has no "
                               f"snapshot (saves: {sorted(self.snapshots)})")
        got = self._state_digest()
        err = None
        if got != snap["digest"]:
            err = SoakInvariantError(
                INV_RESTORE,
                f"post-recovery state digest {got[:12]} != snapshot "
                f"{snap['digest'][:12]} at step {restored}")
        self._agree(err)
        if newest is not None and restored < newest:
            self.fallbacks += 1
            self._say(f"  restore fell back: {newest} → {restored}")

        # renumber the data pipeline onto the survivors
        owned = assign_logical_shards(self.n, active)
        if self.mutate == "renumber":
            # MUTATION: hand hosts each other's shards in reverse order
            # (full coverage, wrong order — only INV2 can see it)
            vals = [owned[h] for h in active][::-1]
            owned = dict(zip(active, vals))
        self.owned = owned
        if mesh is not None:
            tr.rebind_mesh(mesh)
            err = self._check_norms(mesh, restored, snap, len(active))
        self._agree(err)

        self.active = active
        # the launcher only keeps the hosts it placed in the new world
        # beating; dropped-but-alive survivors go silent (idle)
        self.beating = set(active)
        self.recoveries.append(
            {"reason": reason, "restored_step": restored,
             "hosts": list(active)})

    def _check_norms(self, mesh, restored: int, snap: Dict,
                     n_active: int) -> Optional[SoakInvariantError]:
        """INV3 — per-example norms + GNS on the new mesh against the
        single-process oracle at the restored step."""
        tr = self.trainer
        res = tr.engine.step(self.loss, tr.params,
                             self._probe_batch(restored),
                             consumers=self._consumers)
        bs = self.B if self.mutate != "reshard" \
            else self.B // n_active         # MUTATION: local batch size
        gns = float(plan_mod.gradient_noise_scale(res.sq_norms, res.grads,
                                                  batch_size=bs))
        sq = res.sq_norms.float().cpu().numpy()
        if sq.shape != snap["oracle_sq"].shape or \
                not np.allclose(sq, snap["oracle_sq"], rtol=2e-4, atol=1e-6):
            return SoakInvariantError(
                INV_NORMS,
                f"per-example sq norms on the {n_active}-way mesh diverge "
                f"from the single-process oracle at step {restored}")
        ogns = snap["oracle_gns"]
        if abs(gns - ogns) > 5e-3 * max(1.0, abs(ogns)):
            return SoakInvariantError(
                INV_NORMS,
                f"GNS after reshard = {gns:.6g}, single-process oracle = "
                f"{ogns:.6g} at step {restored}")
        return None

    # -- the storm loop ---------------------------------------------------
    def run(self) -> Dict:
        cfg, tr, plan = self.cfg, self.trainer, self.plan
        max_ticks = cfg.steps * 3 + 30
        tick = 0
        while tr.step < cfg.steps:
            if tick > max_ticks:
                raise RuntimeError(
                    f"storm did not converge in {max_ticks} ticks "
                    f"(trained {tr.step}/{cfg.steps})")
            now = float(tick)
            for e in plan.at_tick(tick):
                self._apply_fault(e, tick)
            for h in sorted(self.beating):
                self.monitors[h].beat(tr.step, now=now)
            step_times = {h: plan.straggler_factor(tick, h)
                          for h in self.active}
            self.supervisor.tick(now, step_times=step_times)

            s = tr.step
            batch = dict(self.lm.global_batch_at(s, self.owned))
            # INV2 — the batch assembled from the current host→shard
            # ownership equals the uninterrupted-run stream at s (the same
            # verdict on every rank: the ownership is replicated)
            want = tree_digest(self.lm.global_batch_at(s))
            if tree_digest(batch) != want:
                raise SoakInvariantError(
                    INV_REPLAY,
                    f"step {s}: batch assembled from ownership "
                    f"{self.owned} diverges from the uninterrupted "
                    f"stream (renumbering broke data replay)")
            batch["poison"] = torch.as_tensor(
                plan.poison_vector(s, self.B), device=self.device)
            if self.rank in self.active:
                tr.run_step(batch)
            tr.step += 1
            if tr.step % self.ckpt_every == 0:
                self._save_snapshot()
            tick += 1
        tr.ckpt.wait()
        self.ticks = tick
        return self._finish()

    def _finish(self) -> Dict:
        tr = self.trainer
        for leaf in tree_leaves(tr.params):
            if not bool(torch.isfinite(leaf).all()):
                raise SoakInvariantError(
                    INV_RESTORE, "non-finite parameters after the storm "
                                 "(quarantine failed to contain poison)")
        # the quarantines of every rank that trained a poisoned step
        every: list = [None] * self.n
        dist.all_gather_object(
            every, [e for e in tr.events if e["kind"] == "quarantine"])
        quarantines = []
        for q in (q for qs in every for q in qs):
            if q not in quarantines:
                quarantines.append(q)
        # every scheduled NaN batch must have produced a quarantine of
        # exactly the poisoned rows (examples skipped, steps trained)
        for e in self.plan.events:
            if e.kind != "nan_batch" or e.at >= self.cfg.steps:
                continue
            hits = [q for q in quarantines if q["step"] == e.at]
            if not hits:
                raise SoakInvariantError(
                    INV_REPLAY,
                    f"nan_batch at step {e.at} was never quarantined")
            for q in hits:
                if set(q["examples"]) != set(e.examples):
                    raise SoakInvariantError(
                        INV_REPLAY,
                        f"step {e.at}: quarantined {q['examples']}, "
                        f"poisoned {sorted(set(e.examples))}")
        reasons = [r["reason"] for r in self.recoveries]
        metrics: list = [None] * self.n
        dist.all_gather_object(metrics, tr.metrics[-1] if tr.metrics
                               else None)
        last = metrics[min(self.active)]
        return {
            "steps": self.cfg.steps,
            "ticks": self.ticks,
            "hosts": self.n,
            "final_hosts": len(self.active),
            "recoveries": self.recoveries,
            "contractions": reasons.count("contract") +
                            reasons.count("evict"),
            "expansions": reasons.count("expand"),
            "fallbacks": self.fallbacks,
            "quarantined_steps": sorted({q["step"] for q in quarantines}),
            "quarantined_examples": sorted({i for q in quarantines
                                            for i in q["examples"]}),
            "supervisor_events": len(self.supervisor.events),
            "final_loss": last["loss"] if last else None,
            "invariants": "PASS",
        }


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _build_plan(cfg: SoakConfig) -> ft.FaultPlan:
    if cfg.storm == "random":
        return ft.random_storm(cfg.seed, cfg.hosts, cfg.steps)
    return ft.scripted_storm(cfg.storm, cfg.hosts, cfg.steps)


def _check_coverage(summary: Dict) -> None:
    """The acceptance storm must actually exercise every path."""
    if summary["contractions"] < 2:
        raise MutationCheckError(
            f"storm 'short' produced {summary['contractions']} "
            f"contractions, expected >= 2")
    if summary["expansions"] < 1:
        raise MutationCheckError("storm 'short' never expanded back")
    if summary["fallbacks"] < 1:
        raise MutationCheckError(
            "storm 'short' never exercised checkpoint fallback")
    if not summary["quarantined_steps"]:
        raise MutationCheckError("storm 'short' never exercised quarantine")


def run_soak(cfg: SoakConfig, device: torch.device) -> Dict:
    """One full storm run on this rank of the group; raises
    SoakInvariantError (possibly wrapped in SupervisorHalted) when an
    invariant trips — on every rank alike. ``cfg.workdir`` is shared by
    the group's ranks."""
    plan = _build_plan(cfg)
    world = SoakWorld(cfg, plan, cfg.workdir, device)
    summary = world.run()
    if cfg.storm == "short":
        _check_coverage(summary)
    return summary


def run_mutation_checks(cfg: SoakConfig,
                        device: torch.device) -> Dict[str, str]:
    """Prove the invariants can fail: disable one recovery guard at a time
    and demand the matching invariant trips."""
    results = {}
    for mutate, want in MUTATIONS.items():
        mcfg = dataclasses.replace(
            cfg, mutate=mutate,
            workdir=os.path.join(cfg.workdir, f"mutant_{mutate}"))
        try:
            run_soak(mcfg, device)
        except (SoakInvariantError, ft.SupervisorHalted) as e:
            inv = unwrap_invariant(e)
            if inv is None:
                raise MutationCheckError(
                    f"mutation {mutate!r} halted without an invariant "
                    f"error: {e}") from e
            if inv.invariant != want:
                raise MutationCheckError(
                    f"mutation {mutate!r} tripped {inv.invariant!r}, "
                    f"expected {want!r}") from e
            results[mutate] = inv.invariant
            if cfg.verbose and dist.get_rank() == 0:
                print(f"[soak] mutation {mutate!r}: tripped {want!r} ✓",
                      flush=True)
        else:
            raise MutationCheckError(
                f"mutation {mutate!r} completed the storm — invariant "
                f"{want!r} has no teeth")
    return results


def _rank(rank: int, cfg: SoakConfig, tasks: Sequence[str], tmp: str
          ) -> None:
    """One simulated host: join the gloo group, run ``tasks`` ("storm",
    "mutants") in order, leave the group; write the outcome to ``tmp``."""
    torch.set_num_threads(1)
    if cfg.device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda", 0)
    else:
        device = torch.device(cfg.device)
    warnings.filterwarnings(
        "ignore", message=".*(unreadable|sweeping stale).*")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=cfg.hosts,
                            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    out: Dict = {"error": None}
    try:
        for task in tasks:
            tcfg = dataclasses.replace(
                cfg, workdir=os.path.join(cfg.workdir, task))
            if task == "storm":
                out["summary"] = run_soak(tcfg, device)
            else:
                out["mutation_check"] = run_mutation_checks(tcfg, device)
    except (SoakInvariantError, ft.SupervisorHalted) as e:
        inv = unwrap_invariant(e)
        out["error"] = ("invariant", inv.invariant if inv else "halt",
                        str(e))
    except MutationCheckError as e:
        out["error"] = ("mutation", None, str(e))
    finally:
        dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)


def run_group(cfg: SoakConfig, tasks: Sequence[str] = ("storm",)) -> Dict:
    """Spawn ``cfg.hosts`` gloo ranks (one per simulated host), run
    ``tasks`` on each — ``"storm"`` (one honest storm) and/or
    ``"mutants"`` (the mutation check) — and return the first rank's
    outcome: ``summary``, ``mutation_check`` and ``error`` (None, or
    (kind, invariant, message)). Every rank must report the same error."""
    import torch.multiprocessing as mp

    if cfg.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA device is "
                               "available; pass --device cpu")
        from repro_torch.kernels import _build
        _build.build()      # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        if cfg.workdir is None:
            cfg = dataclasses.replace(cfg, workdir=os.path.join(tmp, "work"))
        mp.start_processes(_rank, args=(cfg, tuple(tasks), tmp),
                           nprocs=cfg.hosts, start_method="spawn")
        outs = []
        for r in range(cfg.hosts):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    kinds = {(o["error"] or (None,))[0] for o in outs}
    if len(kinds) != 1:
        raise RuntimeError(f"the soak's ranks disagree: "
                           f"{[o['error'] for o in outs]}")
    return outs[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="elastic soak harness (DESIGN.md §11)")
    p.add_argument("--hosts", type=int, default=8)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--batch-per-host", type=int, default=2)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="0 = max(2, steps//8)")
    p.add_argument("--storm", default="short",
                   choices=("none", "short", "random"))
    p.add_argument("--workdir", default=None)
    p.add_argument("--mutation-check", action="store_true",
                   help="run the storm with each recovery guard "
                        "disabled; every mutant must trip its invariant")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                   help="where the ranks train (cuda: all on the first "
                        "card, over gloo)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    cfg = SoakConfig(hosts=args.hosts, steps=args.steps, seed=args.seed,
                     arch=args.arch, seq=args.seq,
                     batch_per_host=args.batch_per_host,
                     ckpt_every=args.ckpt_every, storm=args.storm,
                     workdir=args.workdir, verbose=not args.quiet,
                     device=args.device)
    out = run_group(cfg, ("mutants",) if args.mutation_check
                    else ("storm",))
    if out["error"] is not None:
        kind, name, msg = out["error"]
        if kind == "mutation":
            print(f"MUTATION CHECK FAILED: {msg}", file=sys.stderr)
        else:
            print(f"SOAK FAILED [{name}]: {msg}", file=sys.stderr)
        return 1
    if args.mutation_check:
        print(json.dumps({"mutation_check": out["mutation_check"],
                          "status": "PASS"}))
    else:
        print(json.dumps(out["summary"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
