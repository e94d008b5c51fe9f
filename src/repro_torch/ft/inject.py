"""Deterministic fault injection for the per-example-norm pipeline.

Port of ``src/repro/ft/inject.py``: the plans, schedules and checkpoint
faults are the reference's code (``random_storm`` draws with numpy's
generator, so a seed gives the reference's storm); ``poison_loss_fn``
wraps a torch loss (the poison vector a tensor on the loss's device).

A ``FaultPlan`` is a seeded, fully-declared schedule of failure events
— host death, straggler slowdown, checkpoint shard corruption or
truncation, crashed-mid-save ``.tmp`` litter, NaN-poisoned batches,
and host return — injected through the hooks the training stack
already has (heartbeat files, the checkpoint directory, the batch
pytree). Nothing here kills processes or reads wall clocks: the soak
harness (launch/soak.py) advances a simulated clock one tick per
attempted train step, so the same (plan, seed) replays the same storm
bit-for-bit, and a failure found at tick 17 reproduces at tick 17
forever.

Event timebase (DESIGN.md §11): host/checkpoint events fire at a
**tick** (wall-time order — a kill is a kill regardless of which data
step is being retrained), while ``nan_batch`` fires at a **train
step** (the poison lives in the data, so a rollback that replays the
step replays the poison).

Checkpoint faults operate on the *committed* step directories of a
``CheckpointManager`` layout:

* ``ckpt_corrupt``  — flip bytes inside the newest committed shard, so
  the manifest hash no longer matches (restore must fall back).
* ``ckpt_truncate`` — truncate the newest shard file (unreadable npz).
* ``tmp_litter``    — drop a half-written ``step_*.tmp`` dir, the
  debris of a writer that died mid-save.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("host_death", "straggler", "ckpt_corrupt", "ckpt_truncate",
         "tmp_litter", "nan_batch", "host_return")

#: kinds scheduled on the simulated wall clock (ticks); ``nan_batch``
#: is scheduled on the data-step axis instead.
TICK_KINDS = frozenset(k for k in KINDS if k != "nan_batch")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    at: int                       # tick (TICK_KINDS) or train step (nan_batch)
    kind: str
    host: Optional[int] = None            # host_death / straggler
    hosts: Tuple[int, ...] = ()           # host_return
    examples: Tuple[int, ...] = ()        # nan_batch: global example rows
    factor: float = 1.0                   # straggler slowdown multiplier
    duration: int = 1                     # straggler: ticks it persists

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.at < 0:
            raise ValueError(f"event time must be >= 0, got {self.at}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, inspectable storm schedule."""
    events: Tuple[FaultEvent, ...]

    def at_tick(self, tick: int) -> List[FaultEvent]:
        return [e for e in self.events
                if e.kind in TICK_KINDS and e.at == tick]

    def nan_examples(self, train_step: int) -> Tuple[int, ...]:
        out: Tuple[int, ...] = ()
        for e in self.events:
            if e.kind == "nan_batch" and e.at == train_step:
                out = out + e.examples
        return out

    def poison_vector(self, train_step: int, batch_size: int) -> np.ndarray:
        """(B,) float32 multiplier: 1.0 everywhere, NaN on the poisoned
        rows of this train step. Multiplying a loss vector by exactly
        1.0 is a bit-exact no-op, so un-poisoned runs are unchanged."""
        v = np.ones(batch_size, np.float32)
        for i in self.nan_examples(train_step):
            if not 0 <= i < batch_size:
                raise ValueError(f"nan_batch example {i} outside the "
                                 f"global batch of {batch_size}")
            v[i] = np.nan
        return v

    def straggler_factor(self, tick: int, host: int) -> float:
        """Slowdown multiplier for ``host`` at ``tick`` (1.0 = healthy)."""
        f = 1.0
        for e in self.events:
            if (e.kind == "straggler" and e.host == host
                    and e.at <= tick < e.at + e.duration):
                f = max(f, e.factor)
        return f

    def validate(self, n_hosts: int, steps: int) -> "FaultPlan":
        """Static sanity: hosts in range, a host is not killed twice
        without returning, events inside the run."""
        dead: set = set()
        for e in sorted(self.events, key=lambda e: e.at):
            for h in ((e.host,) if e.host is not None else ()) + e.hosts:
                if not 0 <= h < n_hosts:
                    raise ValueError(f"{e.kind}@{e.at}: host {h} outside "
                                     f"world of {n_hosts}")
            if e.kind == "host_death":
                if e.host in dead:
                    raise ValueError(f"host {e.host} killed twice "
                                     f"(tick {e.at}) without returning")
                dead.add(e.host)
            if e.kind == "host_return":
                dead -= set(e.hosts)
        return self


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def scripted_storm(name: str, n_hosts: int, steps: int) -> FaultPlan:
    """The canonical soak storms, scaled to (n_hosts, steps).

    ``short`` is the acceptance storm: litter → transient straggler →
    kill (contract) → corrupt the newest checkpoint → second kill
    (restore must fall back a step) → NaN-poisoned batch (quarantine)
    → hosts return (expand back to full width). Needs n_hosts ≥ 4
    (power of two) and steps ≥ 20 so detection deadlines and
    checkpoint cadence fit between events.
    """
    if name == "none":
        return FaultPlan(())
    if name != "short":
        raise ValueError(f"unknown storm {name!r}; have none/short "
                         f"(or build a FaultPlan / use random_storm)")
    if n_hosts < 4 or n_hosts & (n_hosts - 1):
        raise ValueError(f"storm 'short' needs a power-of-two world of "
                         f">= 4 hosts, got {n_hosts}")
    if steps < 20:
        raise ValueError(f"storm 'short' needs >= 20 steps, got {steps}")

    t = lambda f: max(1, int(round(steps * f)))  # noqa: E731
    kill_a, kill_b = 2 % n_hosts, 0
    returners = tuple(sorted(set(range(n_hosts)) - {1, 3}))
    events = (
        FaultEvent(t(0.08), "tmp_litter"),
        FaultEvent(t(0.12), "straggler", host=1, factor=6.0, duration=2),
        FaultEvent(t(0.20), "host_death", host=kill_a),
        FaultEvent(t(0.40), "host_death", host=kill_b),
        # corrupt the newest committed checkpoint on the kill's
        # *detection* tick (kill at K ⇒ last beat K-1 ⇒ staleness hits
        # the 2.5-tick deadline at K+2; faults apply before the
        # supervisor runs): no save can land in between, so the
        # recovery restore must fall back to the previous committed
        # step
        FaultEvent(t(0.40) + 2, "ckpt_corrupt"),
        FaultEvent(t(0.60), "nan_batch",
                   examples=(3 % (2 * n_hosts), (2 * n_hosts) - 5)),
        FaultEvent(t(0.75), "host_return", hosts=returners),
    )
    return FaultPlan(events).validate(n_hosts, steps)


def random_storm(seed: int, n_hosts: int, steps: int, *,
                 p_kill: float = 0.05, p_ckpt: float = 0.05,
                 p_nan: float = 0.05, max_kills: Optional[int] = None)\
        -> FaultPlan:
    """Seeded random schedule: same (seed, n_hosts, steps, rates) →
    same storm. Kills are capped so the world stays contractible
    (model_parallel=1 worlds survive down to one host)."""
    rng = np.random.default_rng((seed, n_hosts, steps, 0xFA017))
    if max_kills is None:
        max_kills = max(1, n_hosts // 2)
    events: List[FaultEvent] = []
    alive = set(range(n_hosts))
    kills = 0
    for tick in range(2, steps):
        if kills < max_kills and rng.random() < p_kill and len(alive) > 1:
            h = int(rng.choice(sorted(alive)))
            alive.discard(h)
            kills += 1
            events.append(FaultEvent(tick, "host_death", host=h))
        if rng.random() < p_ckpt:
            kind = "ckpt_corrupt" if rng.random() < 0.5 else "tmp_litter"
            events.append(FaultEvent(tick, kind))
        if rng.random() < p_nan:
            b = 2 * n_hosts
            k = int(rng.integers(1, max(2, b // 4)))
            ex = tuple(int(i) for i in
                       rng.choice(b, size=k, replace=False))
            events.append(FaultEvent(tick, "nan_batch", examples=ex))
    if kills:
        back = tuple(sorted(set(range(n_hosts)) - alive))
        events.append(FaultEvent(int(steps * 0.8), "host_return",
                                 hosts=back))
    return FaultPlan(tuple(events)).validate(n_hosts, steps)


# ---------------------------------------------------------------------------
# injection hooks
# ---------------------------------------------------------------------------

def poison_loss_fn(loss_fn):
    """Wrap a tap-collector loss so the (B,) ``batch["poison"]``
    multiplier scales the per-example losses. With the all-ones vector
    this is bit-exact identity (x · 1.0); a NaN entry poisons exactly
    that example's loss — and, through the backward, its per-example
    norm — which is how a bad input batch looks to the trainer."""
    def poisoned(params, batch, tap):
        inner = {k: v for k, v in batch.items() if k != "poison"}
        loss_vec, aux = loss_fn(params, inner, tap)
        return loss_vec * batch["poison"], aux
    return poisoned


def corrupt_newest_checkpoint(ckpt_dir: str, *, truncate: bool = False,
                              host_id: int = 0) -> Optional[int]:
    """Flip bytes in (or truncate) the newest committed shard so its
    manifest hash mismatches. Returns the step corrupted, or None when
    no committed checkpoint exists yet. Deterministic: always the same
    bytes at the same offset."""
    steps = sorted(
        int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
        if name.startswith("step_") and not name.endswith(".tmp"))
    if not steps:
        return None
    step = steps[-1]
    shard = os.path.join(ckpt_dir, f"step_{step:09d}",
                         f"shard_{host_id:05d}.npz")
    if truncate:
        size = os.path.getsize(shard)
        with open(shard, "r+b") as f:
            f.truncate(max(0, size // 2))
    else:
        with open(shard, "r+b") as f:
            f.seek(min(64, max(0, os.path.getsize(shard) - 2)))
            f.write(b"\xde\xad")
    return step


def litter_tmp_dir(ckpt_dir: str, step: int) -> str:
    """Leave the debris of a save that died mid-write: a ``.tmp`` step
    dir holding a torn manifest. ``CheckpointManager`` must both
    ignore it on restore and sweep it on construction."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"step": ')            # torn json
    return path
