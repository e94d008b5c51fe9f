"""One run of one cell: set-up, the checked first steps, the measured
window, the traced steps, and the comparison with the reference.

Set-up builds one training object, the port's ``train.trainer.Trainer``
with its model (weights made from the seed by ``lib.weights``) and its
AdamW state, and drives it through the traffic's ``check_steps`` first
steps by the window's own call (``Trainer.run_step``) and feed
(``lib.data``): the first compiles and warms every shape the window uses.
Those steps' readings are kept: the losses, each example's squared norm
(``Engine.step``'s result, read by a wrapper that is removed before the
window), each leaf's norm of the first gradient as AdamW took it (its
first moment after one step over 1 − β₁) and each leaf's change over the
steps (the starting weights made again from the seed). The same object
then runs the window: steps until ``seconds`` have passed, each ending in
the trainer's own synchronize.

With ``trace``, the window also times every ``Engine.step`` and
``adamw.update`` call by CUDA events, and ``PROFILED_STEPS`` steps after
it run under ``torch.profiler``.

The noise add is read too: each leaf's norm of the first gradient before
the noise (``core.plan.add_grad_noise``'s argument), so that the clip
factors and the reweighted backward are held against the reference under
noise that would drown them in the gradient the optimizer takes.

Once the window has closed and the peak is read, the program's state is
freed and the family's reference (``perfbench/reference/<family>.py``)
follows the same steps from the same weights, tokens and noise generator.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.lib import check, trace, weights
from perfbench.lib.data import SyntheticTokens
from perfbench.lib.spec import Cell

PROFILED_STEPS = 2

#: a seed's offsets for the generators it feeds
NOISE_SEED = 0x5EED


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    batch: int
    seq: int
    setup_s: float
    steps: int = 0
    window_s: float = 0.0
    peak_bytes: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    profile: Optional[trace.Profile] = None

    @property
    def tokens(self) -> int:
        return self.steps * self.batch * self.seq


def family(cell: Cell):
    return importlib.import_module(
        f"perfbench.families.{cell.config['family']}")


def feed(cell: Cell, seed: int, device) -> SyntheticTokens:
    t = cell.traffic
    return SyntheticTokens(cell.config["vocab_size"], t["batch"], t["seq"],
                           seed, n_motifs=t["data"]["n_motifs"],
                           motif_len=t["data"]["motif_len"], device=device)


def noise_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) ^ NOISE_SEED)


def leaf_norms(tree) -> List[float]:
    return [float(torch.linalg.vector_norm(x.to(torch.float32)))
            for _, x in weights.paths(tree)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the port's trainer on the cell's model."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.core import plan as plan_mod
        from repro_torch.core.taps import PexSpec
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.optim import adamw
        from repro_torch.train import trainer as tr
        fam = family(cell)
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = fam.program_config(c)
        fam.check_layout(c, self.cfg)
        self.schema = fam.schema(c)
        self.feed = feed(cell, seed, device)
        consumers = tr.consumers_for_mode(
            t["mode"], t["batch"], clip_norm=t.get("clip_norm", 1.0),
            noise_std=t.get("noise_std", 0.0))
        gen = noise_generator(seed, device)
        given = {plan_mod.Noise: {"rng": gen},
                 plan_mod.Clip: {"granularity":
                                 t.get("granularity", "example")}}
        consumers = tuple(dataclasses.replace(x, **given.get(type(x), {}))
                          for x in consumers)
        self.trainer = tr.Trainer(
            fam.loss_fn(c, self.cfg), weights.make(self.schema, seed, device),
            PexSpec(), adamw.AdamWConfig(**t["adamw"]),
            tr.TrainConfig(consumers=consumers, seed=int(seed) % 2**63),
            DataConfig(vocab=c["vocab_size"], seq=t["seq"],
                       global_batch=t["batch"], seed=int(seed)),
            data=self.feed, device=device)

    def step(self) -> Dict:
        tr = self.trainer
        m = tr.run_step(self.feed.batch_at(tr.step))
        tr.step += 1
        return m

    def check_steps(self, n: int) -> Dict:
        """Run the first ``n`` steps and keep their readings."""
        from repro_torch.core import plan as plan_mod
        tr = self.trainer
        engine_step = tr.engine.step
        add_noise = plan_mod.add_grad_noise
        sq: List = []
        chosen: List = []
        clean: List = []

        def reading(*args, **kwargs):
            res = engine_step(*args, **kwargs)
            if res.sq_norms is not None:
                sq.append(res.sq_norms.to(torch.float32).sum(-1).tolist())
            return res

        def noising(grads, *args, **kwargs):
            if not clean:
                clean.append(leaf_norms(grads))
            return add_noise(grads, *args, **kwargs)
        tr.engine.step = reading
        plan_mod.add_grad_noise = noising
        out = {"loss": [], "routes": []}
        try:
            with family(self.cell).reading_routes(
                    self.cfg, self.cell.traffic["batch"], chosen) as routed:
                for i in range(n):
                    chosen.clear()
                    out["loss"].append(float(self.step()["loss"]))
                    out["routes"].append(list(chosen[:routed]))
                    if i == 0:
                        b1 = tr.opt_cfg.b1
                        out["grad_seen"] = [x / (1.0 - b1) for x in
                                            leaf_norms(tr.opt_state.mu)]
        finally:
            del tr.engine.step
            plan_mod.add_grad_noise = add_noise
        if clean:
            out["grad_clean"] = clean[0]
        out["sq_norms"] = sq
        start = weights.make(self.schema, self.seed, self.device)
        out["update"] = [
            float(torch.linalg.vector_norm(p.to(torch.float32)
                                           - p0.to(torch.float32)))
            for (_, p), (_, p0) in zip(weights.paths(tr.params),
                                       weights.paths(start))]
        del start
        return out

    def window(self, seconds: float, run: Run) -> List[Dict]:
        sync(self.device)
        ms = []
        t0 = time.perf_counter()
        while True:
            ms.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.steps = len(ms)
        return ms

    def free(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(cell: Cell, seed: int, device, steps: int, *, mm=None,
              alter: Optional[Callable] = None,
              reweight: Optional[Callable] = None,
              routes: Optional[List] = None) -> Dict:
    """The reference's readings of the first ``steps`` steps, by the
    family's reference (``perfbench/reference/<family>.py``), following
    ``routes`` (the experts chosen in the program's place) where given."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam = cell.config["family"]
    model = importlib.import_module(f"perfbench.reference.{fam}")
    schema = family(cell).schema(cell.config)
    params = weights.map_tree(lambda x: x.to(torch.float32),
                              weights.make(schema, seed, device))
    gc.collect()
    data = feed(cell, seed, device)
    batches = [(b["ids"], b["labels"])
               for b in map(data.batch_at, range(steps))]
    noise = noise_generator(seed, device) if wants_noise(cell) else None
    out = model.follow(params, cell.config, cell.traffic, batches,
                       noise_gen=noise, mm=mm, alter=alter,
                       reweight=reweight, routes=routes)
    start = weights.make(schema, seed, device)
    out["update"] = [
        float(torch.linalg.vector_norm(p - p0.to(torch.float32)))
        for (_, p), (_, p0) in zip(weights.paths(params),
                                   weights.paths(start))]
    del params, start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def wants_norms(cell: Cell) -> bool:
    return cell.traffic["mode"] in ("clip", "norms")


def wants_noise(cell: Cell) -> bool:
    t = cell.traffic
    return t["mode"] == "clip" and bool(t.get("noise_std"))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Dict:
    """One run; returns the result line's fields (and ``run``, the
    ``Run`` the metrics read)."""
    from repro_torch.optim import adamw
    device = torch.device(device)
    t = cell.traffic
    prog = Program(cell, seed, device)
    got = prog.check_steps(t["check_steps"])
    sync(device)
    run = Run(cell, t["batch"], t["seq"],
              setup_s=time.perf_counter() - t_start)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    spans = trace.Spans(device)
    update = adamw.update
    if traced:
        prog.trainer.engine.step = spans.wrap("engine.step",
                                              prog.trainer.engine.step)
        adamw.update = spans.wrap("adamw.update", update)
    try:
        ms = prog.window(seconds, run)
    finally:
        if traced:
            del prog.trainer.engine.step
            adamw.update = update
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    run.spans = {k: spans.ms(k) for k in spans.marks}
    if traced:
        run.profile = profiled(prog, device)
    failed = sum(1 for m in ms if m.get("skipped") or m.get("quarantined")
                 or not math.isfinite(m["loss"]))
    prog.free()
    ref = reference(cell, seed, device, t["check_steps"],
                    routes=got["routes"] if got["routes"][0] else None)
    nums = check.numbers(got, ref, wants_norms(cell), wants_noise(cell))
    correct, checks = check.decide(nums, cell.limits)
    return {"correct": correct, "attempted": len(ms), "failed": failed,
            "checks": checks, "run": run, "program": got, "reference": ref}


def profiled(prog: Program, device) -> trace.Profile:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(PROFILED_STEPS):
            with record_function(trace.STEP_MARK):
                prog.step()
        sync(device)
    return trace.Profile(prof, PROFILED_STEPS)
