"""Training loop over declarative consumer plans.

Port of ``src/repro/train/trainer.py``. A step is described
by a **consumer list** that ``Engine.step`` runs as one fused pass:

    TrainConfig(consumers=(pex.Clip(1.0), pex.Noise(0.1), pex.GNS()))

runs DP-SGD clipping, noise and gradient-noise-scale telemetry off one
tapped forward, one norms backward and one reweighted backward.
``consumers_for_mode`` maps the launcher's mode names onto consumer lists.

The reference splits a JAX step key into the ``Noise``/``Importance``
slots left at ``rng=None``. The port's trainer owns a ``torch.Generator``
on its device, seeded from ``TrainConfig.seed``; every step it draws one
seed per such slot, in the list's order, and gives each slot a child
generator from its seed (a quarantine retry reuses the same seeds, as the
reference reuses its step key). The step runs eagerly; the optimizer
changes the parameters in place once the step's loss and norms are known
to be finite.

Integrates AdamW, optional int8 error-feedback gradient compression,
quarantine of non-finite examples, async checkpointing and deterministic
resume (``TrainConfig.ckpt_dir`` / ``ckpt_every``, ``save_checkpoint``,
``restore_from``, ``train(resume=True)``): a checkpoint holds the
parameters and both AdamW moments, and its ``extra`` the step, the
optimizer step, the seed and the data cursor (``RESUME_EXTRA_KEYS``). As in
the reference, the generator behind ``Noise``/``Importance`` slots is not
saved, so a resumed run with a noise draw forks from the run that did not
stop; one with no draw resumes bit for bit.

``mesh=`` (a ``DeviceMesh``) runs every step data-parallel through
``dist.pex`` over ``data_axes``, one process per rank. Every rank holds
the same parameters (the same init seed; checked once by a broadcast from
the first rank), draws the same ``batch_at(step)`` and the same child
generators, and runs AdamW on the same reduced gradient, so the replicas
stay bit-identical. ``compress_grads`` compresses the reduced gradient,
before the optimizer, as the reference's trainer does. Quarantine reads
the global per-example losses and norms. ``rebind_mesh`` moves the trainer
onto another mesh (the elastic primitive the soak harness drives).

Checkpoints on a mesh: the checkpoint directory is shared, and only the
first rank of the data axes writes it (N processes renaming the same
``step_*.tmp`` would race); it commits before a barrier over the data
group releases the others. Every rank restores, after a barrier, from the
same files. The first rank also constructs its ``CheckpointManager``
(which sweeps stale ``.tmp`` litter) before the others.

The reference's ``TrainConfig.microbatches``, which its trainer never
reads, is not carried over.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import Engine, infer_batch_size
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig, PipelineState, SyntheticLM
from repro_torch.dist import pex as dpex
from repro_torch.nn.param import resolve_device, tree_leaves, tree_map
from repro_torch.optim import adamw, grad_compress


@dataclasses.dataclass
class TrainConfig:
    #: the consumer plan for every step; None ⇒ (Norms(), Grads())
    consumers: Optional[Sequence] = None
    compress_grads: bool = False
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0


def consumers_for_mode(mode: str, batch_size: int, *,
                       clip_norm: float = 1.0, noise_std: float = 0.0,
                       candidate_factor: int = 4,
                       importance_smoothing: float = 0.2) -> Tuple:
    """Mode names → consumer lists (the launcher's contract).

    plain       — gradient only (no instrumentation at all)
    norms       — grads + per-example norms in one backward (§4/§5)
    clip        — per-example clipping (§6); + Noise when noise_std>0
    importance  — norms on the pool → sample batch/candidate_factor
                  examples ∝ norm → weighted step on the sub-batch
    """
    if mode == "plain":
        return (plan_mod.Grads(),)
    if mode == "norms":
        return (plan_mod.Norms(), plan_mod.Grads())
    if mode == "clip":
        cons = [plan_mod.Norms(), plan_mod.Clip(clip_norm)]
        if noise_std > 0.0:
            cons.append(plan_mod.Noise(noise_std))
        return tuple(cons)
    if mode == "importance":
        return (plan_mod.Importance(batch_size // candidate_factor,
                                    smoothing=importance_smoothing),
                plan_mod.Grads())
    raise ValueError(f"unknown mode {mode!r}; have plain/norms/clip/"
                     f"importance (or pass TrainConfig(consumers=...))")


#: checkpoint ``extra`` keys a resume refuses to run without: the step
#: cursor, the optimizer step, the trainer seed, and the data-pipeline
#: state (which carries its own step/seed — PipelineState.from_dict
#: validates those).
RESUME_EXTRA_KEYS = ("step", "opt_step", "seed", "data")

_RNG_CONSUMERS = (plan_mod.Noise, plan_mod.Importance)


class Trainer:
    def __init__(self, loss_fn: Callable, params, pex_spec: PexSpec,
                 opt_cfg: adamw.AdamWConfig, train_cfg: TrainConfig,
                 data_cfg: DataConfig, *, mesh=None, data_axes=("data",),
                 data=None, device=None):
        """``loss_fn`` is the tap-collector loss
        (``registry.make_loss_fn_v2``); ``params`` lie on ``device``
        (default CUDA; the trainer raises without one). ``mesh=None`` runs
        on this process alone; a mesh routes every step through the
        data-parallel pipeline (``dist.pex``), gradients all-reduced over
        ``data_axes``. ``data`` overrides the default
        ``SyntheticLM(data_cfg)`` with any source exposing
        ``batch_at(step)``."""
        self.device = resolve_device(device)
        on = {x.device.type for x in tree_leaves(params)}
        if on != {self.device.type}:
            raise ValueError(f"the parameters lie on {sorted(on)} and the "
                             f"trainer runs on {self.device}; pass device=")
        self.loss_fn = loss_fn
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.consumers = tuple(train_cfg.consumers) \
            if train_cfg.consumers is not None \
            else (plan_mod.Norms(), plan_mod.Grads())
        if not any(isinstance(c, (plan_mod.Grads, plan_mod.Clip,
                                  plan_mod.Noise, plan_mod.GNS))
                   for c in self.consumers):
            raise ValueError(
                f"training needs a gradient-producing consumer "
                f"(Grads/Clip/Noise/GNS); got {self.consumers}")
        self.pex_spec = pex_spec
        self.data_axes = data_axes
        self.engine = Engine(pex_spec, mesh=mesh, data_axes=data_axes)
        if mesh is not None:
            dpex.check_replicated(params, mesh, data_axes)
        self.data = data if data is not None \
            else SyntheticLM(data_cfg, device=self.device)
        self.params = params
        self.opt_state = adamw.init(params)
        self.err = grad_compress.init_error(params) \
            if train_cfg.compress_grads else None
        self.step = 0
        self.gen = torch.Generator(device=self.device).manual_seed(
            train_cfg.seed)
        self.ckpt: Optional[CheckpointManager] = None
        if train_cfg.ckpt_dir:
            self._make_manager()
        self.metrics: list = []
        #: graceful-degradation log: quarantine / skip events
        self.events: list = []

    # -- generators for rng=None slots ------------------------------------
    def _draw_seeds(self) -> list:
        """One seed per ``rng=None`` Noise/Importance slot, drawn from the
        trainer's generator (nothing is drawn when no slot needs one)."""
        n = sum(isinstance(c, _RNG_CONSUMERS) and c.rng is None
                for c in self.consumers)
        if not n:
            return []
        return torch.randint(0, 2 ** 62, (n,), generator=self.gen,
                             device=self.device).tolist()

    def _with_rngs(self, seeds: list) -> Tuple:
        """The consumer list with each ``rng=None`` slot given a child
        generator from its seed, in the list's order."""
        it = iter(seeds)
        return tuple(
            dataclasses.replace(c, rng=torch.Generator(
                device=self.device).manual_seed(next(it)))
            if isinstance(c, _RNG_CONSUMERS) and c.rng is None else c
            for c in self.consumers)

    # -- graceful degradation ---------------------------------------------
    @staticmethod
    def _quarantine_mask(res) -> Optional[np.ndarray]:
        """True for examples whose loss and per-example norms are finite.
        None when every example is bad (nothing to salvage)."""
        mask = torch.isfinite(res.loss_vec.to(torch.float32))
        if res.sq_norms is not None:
            per_ex = torch.isfinite(res.sq_norms.to(torch.float32))
            mask &= per_ex.reshape(per_ex.shape[0], -1).all(dim=1)
        mask = mask.cpu().numpy()
        return mask if mask.any() else None

    @staticmethod
    def _substitute_rows(batch, mask: np.ndarray):
        """Replace quarantined rows with the first healthy row. Their zero
        loss weight removes the substitute's (finite) gradient exactly;
        substitution keeps NaNs made in the forward out of the step — a
        zero seed does not (0·NaN = NaN)."""
        b = infer_batch_size(batch)
        donor = int(np.argmax(mask))

        def sub(x):
            if not isinstance(x, torch.Tensor) or x.ndim == 0 \
                    or x.shape[0] != b:
                return x
            keep = torch.as_tensor(mask, device=x.device).reshape(
                (b,) + (1,) * (x.ndim - 1))
            return torch.where(keep, x, x[donor][None])

        return tree_map(sub, batch)

    def _apply(self, grads) -> None:
        if self.err is not None:
            grads, self.err = grad_compress.compress_decompress(grads,
                                                                self.err)
        self.params, self.opt_state = adamw.update(
            self.opt_cfg, self.opt_state, self.params, grads)

    # ----------------------------------------------------------------------
    def run_step(self, batch) -> Dict:
        t0 = time.perf_counter()
        seeds = self._draw_seeds()
        res = self.engine.step(self.loss_fn, self.params, batch,
                               self._with_rngs(seeds))
        loss = float(res.loss)
        bad = not math.isfinite(loss)
        if not bad and res.sq_norms is not None:
            bad = not bool(torch.isfinite(res.sq_norms).all())
        quarantined = 0
        if bad:
            # the per-example losses and norms the pass already computed
            # name the poisoned examples; weight them out and run again —
            # skip examples, not steps
            mask = self._quarantine_mask(res)
            if mask is None:
                self.events.append({"step": self.step, "kind": "skip_step",
                                    "reason": "every example non-finite"})
                m = {"step": self.step, "loss": loss,
                     "time_s": time.perf_counter() - t0, "skipped": 1}
                self.metrics.append(m)
                return m          # parameters and optimizer state kept
            quarantined = int((~mask).sum())
            self.events.append({
                "step": self.step, "kind": "quarantine",
                "examples": [int(i) for i in np.flatnonzero(~mask)]})
            res = self.engine.step(
                self.loss_fn, self.params,
                self._substitute_rows(batch, mask), self._with_rngs(seeds),
                loss_weights=torch.as_tensor(mask, dtype=torch.float32,
                                             device=self.device))
            loss = float(res.loss)
        self._apply(res.grads)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        m = {"step": self.step, "loss": loss,
             "time_s": time.perf_counter() - t0}
        if quarantined:
            m["quarantined"] = quarantined
        if res.sq_norms is not None:
            norms = torch.sqrt(torch.sum(res.sq_norms, -1))
            m["norm_mean"] = float(torch.mean(norms))
            m["norm_max"] = float(torch.max(norms))
        if res.gns is not None:
            m["gns"] = float(res.gns)
        self.metrics.append(m)
        return m

    # -- elastic rebinding ------------------------------------------------
    def rebind_mesh(self, mesh, data_axes=None) -> None:
        """Run the next steps on another mesh (None: this process alone),
        after a contraction or expansion. The parameters and optimizer
        state stay where they are; on a mesh, every rank's parameters are
        checked against the first rank's again."""
        if data_axes is not None:
            self.data_axes = data_axes
        self.engine = Engine(self.pex_spec, mesh=mesh,
                             data_axes=self.data_axes)
        if mesh is not None:
            dpex.check_replicated(self.params, mesh, self.data_axes)

    # -- checkpoint plumbing ----------------------------------------------
    def _data_shards(self, mesh=None):
        """This rank's place on the data axes of ``mesh`` (default: the
        engine's), or None off a mesh."""
        mesh = self.engine.mesh if mesh is None else mesh
        return None if mesh is None else dpex.data_shards(mesh,
                                                          self.data_axes)

    def _make_manager(self) -> None:
        """The checkpoint manager; on a mesh the first rank constructs (and
        sweeps stale ``.tmp`` litter) before the others."""
        shards = self._data_shards()
        if shards is None or shards.index == 0:
            self.ckpt = CheckpointManager(self.cfg.ckpt_dir)
        if shards is not None:
            dist.barrier(group=shards.group)
            if shards.index:
                self.ckpt = CheckpointManager(self.cfg.ckpt_dir)

    def _state_tree(self):
        return {"params": self.params, "mu": self.opt_state.mu,
                "nu": self.opt_state.nu}

    def _ckpt_extra(self) -> Dict:
        return {"step": self.step, "opt_step": int(self.opt_state.step),
                "seed": self.cfg.seed,
                "data": PipelineState(step=self.step,
                                      seed=self.data_cfg.seed).to_dict()}

    def save_checkpoint(self, block: bool = False) -> None:
        """Save the state at ``self.step``: the device→host copy now, the
        write on the manager's thread (``block`` waits for the commit). On a
        mesh the first data rank writes and commits, then a barrier over
        the data group releases every rank."""
        assert self.ckpt is not None, "no ckpt_dir configured"
        shards = self._data_shards()
        if shards is None:
            self.ckpt.save(self.step, self._state_tree(),
                           extra=self._ckpt_extra(), block=block)
            return
        try:
            if shards.index == 0:
                self.ckpt.save(self.step, self._state_tree(),
                               extra=self._ckpt_extra(), block=True)
        finally:
            dist.barrier(group=shards.group)

    def _validate_extra(self, extra: Dict) -> PipelineState:
        missing = [k for k in RESUME_EXTRA_KEYS if k not in extra]
        if missing:
            raise ValueError(
                f"checkpoint extra is missing key(s) {missing} (have "
                f"{sorted(extra)}); refusing to resume — a checkpoint "
                f"without step/seed/pipeline state cannot be replayed "
                f"deterministically")
        if int(extra["seed"]) != self.cfg.seed:
            raise ValueError(
                f"checkpoint was written by a run with seed="
                f"{extra['seed']}, this trainer has seed={self.cfg.seed}; "
                f"resuming would fork the rng/noise stream")
        ps = PipelineState.from_dict(extra["data"])
        if ps.seed != self.data_cfg.seed:
            raise ValueError(
                f"checkpoint data stream has seed={ps.seed}, this "
                f"trainer's pipeline has seed={self.data_cfg.seed}; "
                f"resuming would replay different batches")
        return ps

    def restore_from(self, step: Optional[int] = None,
                     shardings=None) -> int:
        """Restore params/opt-state/step from the newest restorable
        checkpoint (≤ ``step`` if given; CheckpointManager falls back past
        corrupt ones), after validating the ``extra`` payload. The leaves
        land on the trainer's device, or with ``shardings`` (a
        ``dist.sharding.Sharding`` of replicated placements) on its mesh's
        device, checked equal across its ranks. On a mesh (``shardings``'
        or the engine's) every rank waits at a barrier over the data group
        first. Returns the step actually restored."""
        assert self.ckpt is not None, "no ckpt_dir configured"
        self.ckpt.wait()        # surface writer-thread failures first
        shards = self._data_shards(getattr(shardings, "mesh", None))
        if shards is not None:
            dist.barrier(group=shards.group)
        restored, extra = self.ckpt.restore(step, self._state_tree(),
                                            shardings=shardings,
                                            device=self.device)
        ps = self._validate_extra(extra)
        self.params = restored["params"]
        self.opt_state = adamw.AdamWState(int(extra["opt_step"]),
                                          restored["mu"], restored["nu"])
        self.step = int(extra["step"])
        assert ps.step == self.step, \
            f"pipeline cursor {ps.step} != trainer step {self.step}"
        return self.step

    # ----------------------------------------------------------------------
    def train(self, resume: bool = False) -> list:
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            self.restore_from(None)
        while self.step < self.cfg.steps:
            m = self.run_step(self.data.batch_at(self.step))
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"[{self.step}] " + " ".join(
                    f"{k}={v:.4g}" for k, v in m.items() if k != "step"))
            if self.ckpt and self.step % self.cfg.ckpt_every == 0:
                self.save_checkpoint()
        if self.ckpt:
            self.ckpt.wait()
        return self.metrics
