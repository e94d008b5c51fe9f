"""Training loop over declarative consumer plans.

Port of ``src/repro/train/trainer.py`` for one device. A step is described
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

Integrates AdamW, optional int8 error-feedback gradient compression and
quarantine of non-finite examples. Not in this slice, and refused rather
than ignored: meshes (``mesh=``, ``rebind_mesh``; ROADMAP.md Queue 1 item
9) and checkpointing (``TrainConfig.ckpt_dir``, ``save_checkpoint``,
``restore_from``, ``train(resume=True)``; item 10). The reference's
``TrainConfig.microbatches`` (which its trainer never reads) and
``ckpt_every`` (which comes with checkpointing) are not carried over.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import Engine, infer_batch_size
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.nn.param import resolve_device, tree_leaves, tree_map
from repro_torch.optim import adamw, grad_compress

WAITS = ("is not ported yet: meshes and the data-parallel all-reduce wait "
         "for ROADMAP.md Queue 1 item 9, checkpointing and elastic "
         "rebinding for Queue 1 item 10")


@dataclasses.dataclass
class TrainConfig:
    #: the consumer plan for every step; None ⇒ (Norms(), Grads())
    consumers: Optional[Sequence] = None
    compress_grads: bool = False
    steps: int = 100
    log_every: int = 10
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
#: cursor, the optimizer step, the trainer seed and the data-pipeline
#: state (checkpointing itself waits for ROADMAP.md Queue 1 item 10)
RESUME_EXTRA_KEYS = ("step", "opt_step", "seed", "data")

_RNG_CONSUMERS = (plan_mod.Noise, plan_mod.Importance)


class Trainer:
    def __init__(self, loss_fn: Callable, params, pex_spec: PexSpec,
                 opt_cfg: adamw.AdamWConfig, train_cfg: TrainConfig,
                 data_cfg: DataConfig, *, mesh=None, data=None, device=None):
        """``loss_fn`` is the tap-collector loss
        (``registry.make_loss_fn_v2``); ``params`` lie on ``device``
        (default CUDA; the trainer raises without one). ``data`` overrides
        the default ``SyntheticLM(data_cfg)`` with any source exposing
        ``batch_at(step)``."""
        if mesh is not None:
            raise NotImplementedError(f"Trainer(mesh=...) {WAITS}")
        if train_cfg.ckpt_dir is not None:
            raise NotImplementedError(f"TrainConfig.ckpt_dir {WAITS}")
        self.device = resolve_device(device)
        on = {x.device.type for x in tree_leaves(params)}
        if on != {self.device.type}:
            raise ValueError(f"the parameters lie on {sorted(on)} and the "
                             f"trainer runs on {self.device}; pass device=")
        self.loss_fn = loss_fn
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg
        self.consumers = tuple(train_cfg.consumers) \
            if train_cfg.consumers is not None \
            else (plan_mod.Norms(), plan_mod.Grads())
        if not any(isinstance(c, (plan_mod.Grads, plan_mod.Clip,
                                  plan_mod.Noise, plan_mod.GNS))
                   for c in self.consumers):
            raise ValueError(
                f"training needs a gradient-producing consumer "
                f"(Grads/Clip/Noise/GNS); got {self.consumers}")
        self.engine = Engine(pex_spec)
        self.data = data if data is not None \
            else SyntheticLM(data_cfg, device=self.device)
        self.params = params
        self.opt_state = adamw.init(params)
        self.err = grad_compress.init_error(params) \
            if train_cfg.compress_grads else None
        self.step = 0
        self.gen = torch.Generator(device=self.device).manual_seed(
            train_cfg.seed)
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

    # -- not in this slice ------------------------------------------------
    def save_checkpoint(self, block: bool = False) -> None:
        raise NotImplementedError(f"Trainer.save_checkpoint {WAITS}")

    def restore_from(self, step: Optional[int] = None,
                     shardings=None) -> int:
        raise NotImplementedError(f"Trainer.restore_from {WAITS}")

    def rebind_mesh(self, mesh, data_axes=None) -> None:
        raise NotImplementedError(f"Trainer.rebind_mesh {WAITS}")

    # ----------------------------------------------------------------------
    def train(self, resume: bool = False) -> list:
        if resume:
            raise NotImplementedError(f"Trainer.train(resume=True) {WAITS}")
        while self.step < self.cfg.steps:
            m = self.run_step(self.data.batch_at(self.step))
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"[{self.step}] " + " ".join(
                    f"{k}={v:.4g}" for k, v in m.items() if k != "step"))
        return self.metrics
