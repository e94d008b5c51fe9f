"""Dry-run of the port's cells: one record a cell on ``meta`` tensors, its
predicted peak device memory from a liveness pass, its flops and bytes.

Port of ``src/repro/launch/dryrun.py``. The reference compiled each
(arch × shape × mesh) cell onto 512 fake XLA host devices and read XLA's
memory and cost analyses. The port has no compiler to ask; it records the
cell's program once on ``meta`` tensors (``analysis._trace``), nothing
allocated and nothing computed, and reads:

  * **memory** — a liveness pass over the record: every storage an op makes
    lives from the op that first writes it to the last op that touches it
    (autograd's saved tensors so live until the backward op that reads
    them), the step's outputs to its end; the parameters, the optimizer
    state (or a serve cell's caches), the batch and anything else the
    record reads but did not make are resident throughout. The predicted
    peak per device is the resident bytes plus the most the made storages
    take at once, held against the profile's 80 GB (``fits``);
  * **cost** — the record's flops and bytes (``roofline.hlo``), and its
    all-reduces' operand bytes.

Two modes, as the reference has:

  * **sharded** (the default; the reference's GSPMD mode): the cell runs
    on the reference's production mesh, 16×16 over ("data", "model") or,
    with ``--multi-pod``, 2×16×16 over ("pod", "data", "model") — (4, 4)
    and (2, 4, 4) under ``--smoke`` — with the reference's logical→mesh
    rules (``models.registry.rules_for``). Parameters, AdamW state, batch
    and caches are DTensors laid out by those rules (the reference's
    ``_batch_shardings``, ``_cache_shardings`` and ``_opt_shardings``),
    the step runs the sharded route (``core.plan``: ``Engine`` with
    ``mesh=None`` under ``use_rules(mesh, rules)``), and the record holds
    rank 0's own work: its local shards and the collectives DTensor sends
    (``analysis._trace``). A train cell accumulates the gradient over the
    arch's ``train_microbatches`` (deepseek-v2-236b: 2), as the reference
    does. Each device's parameter and state bytes are also computed
    analytically from the shardings (:func:`tree_bytes_per_dev`, the
    reference's ``_tree_bytes_per_dev``), and the record's own are held
    to them;
  * **pex-spmd** (``--pex-spmd``): the data-only mesh path (``dist.pex``
    with per-rank norms and one gradient all-reduce over N data ranks,
    ``--ranks``). Each rank holds the local batch B/N, the parameters
    replicated, and the optimizer state; where the batch does not split
    over the ranks the cell is refused, as ``dist.pex`` refuses it. One
    rank runs the local path, as a single card does. A serve cell records
    one ``forward_tokens`` call of the local requests (ceil(B/N): each
    rank is a replica serving its own) against caches of the shape's
    length.

Either world exists only as a recorded mesh: ``torch.distributed``'s
``fake`` process-group backend
(``torch.testing._internal.distributed.fake_pg``) makes it in this one
process, and rank 0's record is the cell's; no process is spawned, and no
collective is sent.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pex-spmd \\
        --arch llama3.2-1b --shape train_4k --ranks 256
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pex-spmd --smoke
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.roofline import hlo
from repro_torch.roofline.constants import DEFAULT_PROFILE, get_profile

#: reduced shapes for the CPU regression run (``--smoke``)
_EXTRA_SHAPES = {
    "smoke_train": ShapeSpec("smoke_train", "train", 16, 8),
    "smoke_prefill": ShapeSpec("smoke_prefill", "prefill", 16, 8),
    "smoke_decode": ShapeSpec("smoke_decode", "decode", 16, 8),
}

#: the reference's documented skips (``ArchSpec.skip_shapes``): the
#: full-attention archs at 524k tokens
SKIP = {a: ("long_500k",) for a in (
    "llama3.2-1b", "qwen2-7b", "qwen2-vl-7b", "minitron-4b", "gemma2-9b",
    "phi3.5-moe", "deepseek-v2-236b", "seamless-m4t-medium")}
SKIP_REASON = ("full attention: the quadratic scores and the O(s) KV cache "
               "per layer at 524k tokens (the reference skips it too)")


def shape_spec(name: str) -> ShapeSpec:
    return SHAPES.get(name) or _EXTRA_SHAPES[name]


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    ranks: int
    ok: bool
    skipped: bool = False
    reason: str = ""
    record_s: float = 0.0
    local_batch: int = 0
    n_ops: int = 0
    flops: float = 0.0                 # one rank's record
    bytes_accessed: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    param_bytes_per_dev: float = 0.0
    state_bytes_per_dev: float = 0.0   # optimizer state or caches
    batch_bytes_per_dev: float = 0.0
    other_bytes_per_dev: float = 0.0   # read, not made: constants
    transient_peak_bytes: float = 0.0  # made storages at the peak
    peak_bytes_per_dev: float = 0.0
    peak_op: int = -1
    fits: bool = False
    profile: str = DEFAULT_PROFILE
    n_params: float = 0.0
    error: str = ""
    mode: str = "pex-spmd"             # or "sharded"
    mesh: str = ""                     # the sharded mode's mesh, "16x16"
    microbatches: int = 1
    param_bytes_analytic: float = 0.0  # sharded: tree_bytes_per_dev
    state_bytes_analytic: float = 0.0
    collective_findings: list = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Liveness:
    """Bytes of a record: ``resident`` (storages it read but did not make,
    by the group ``groups`` names them in, "other" for the rest) and the
    peak of the storages it made (``peak``, at record ``at``)."""
    resident: Dict[str, float]
    peak: float
    at: int

    @property
    def total(self) -> float:
        return sum(self.resident.values()) + self.peak


def liveness(trace, groups: Dict[str, Sequence[int]] = (),
             keep: Sequence[int] = ()) -> Liveness:
    """The liveness pass (module docstring) over one record. ``groups``
    names resident tensors by tensor id ({"params": ids, ...}); ``keep``
    are tensor ids whose storages live to the end (the step's outputs)."""
    tensors = trace.tensors
    size: Dict[int, int] = {}
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    made: Dict[int, int] = {}
    for info in tensors.values():
        size[info.storage] = max(size.get(info.storage, 0),
                                 info.storage_bytes)
    for op in trace.ops:
        i = op.index
        for t in op.ins:
            s = tensors[t].storage
            first.setdefault(s, i)
            last[s] = i
        for t in op.outs:
            s = tensors[t].storage
            first.setdefault(s, i)
            made.setdefault(s, i)
            last[s] = i
        for s in op.writes:
            last[s] = i
    end = len(trace.ops)
    for t in keep:
        last[tensors[t].storage] = end
    named: Dict[int, str] = {}
    for name, ids in dict(groups).items():
        for t in ids:
            named.setdefault(tensors[t].storage, name)
    resident: Dict[str, float] = {name: 0.0 for name in dict(groups)}
    resident.setdefault("other", 0.0)
    born = [0] * (end + 1)
    died = [0] * (end + 1)
    for s, i in first.items():
        if s in named or made.get(s, end + 1) > i:
            # read before (or without) being made here: resident
            key = named.get(s, "other")
            resident[key] += size.get(s, 0)
            continue
        born[i] += size.get(s, 0)
        died[last[s]] += size.get(s, 0)
    cur = peak = 0
    at = -1
    for i in range(end + 1):
        cur += born[i]
        if cur > peak:
            peak, at = cur, i
        cur -= died[i]
    return Liveness(resident, float(peak), at)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_world(ranks: int):
    """A ``ranks``-rank world in this process on the ``fake`` backend and
    its ("data", "model") host mesh on the CPU (None for one rank: the
    local path)."""
    if ranks <= 1:
        yield None
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already up; a "
                           "recorded world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def record_train(aspec, cfg, b: int, s: int, *, ranks: int = 1,
                 consumers: Optional[Sequence] = None,
                 optimizer: str = "adamw", spec=None):
    """(TrainTrace, local batch) of one training step of ``cfg`` on a
    global batch (``b``, ``s``) over ``ranks`` data ranks: rank 0's
    record."""
    from repro_torch import pex
    from repro_torch.analysis import _trace
    from repro_torch.models import registry
    consumers = list(consumers) if consumers is not None \
        else [pex.Norms(), pex.Grads()]
    if b % ranks:
        raise ValueError(f"a batch of {b} does not split over {ranks} data "
                         f"ranks (dist.pex takes B % N == 0)")
    mod = registry.family_module(aspec)
    params = mod.init(cfg, torch.Generator().manual_seed(0), device="meta")
    bt = registry.make_train_batch(aspec, cfg, ShapeSpec("dryrun", "train",
                                                         s, b), device="cpu")
    bt = _trace.to_meta(bt)
    with recorded_world(ranks) as mesh:
        tt = _trace.trace_train_step(
            registry.make_loss_fn_v2(aspec, cfg), params, bt, consumers,
            optimizer=optimizer, spec=spec, mesh=mesh, seq=s,
            with_reference=False)
    return tt, b // ranks


def train_liveness(tt) -> Liveness:
    """The liveness of a recorded training step, its parameters, optimizer
    state and batch named."""
    keep = [t for _, _, t in tt.outputs]
    return liveness(tt, {"params": tt.param_ids, "state": tt.opt_ids,
                         "batch": tt.batch_ids}, keep)


def record_serve(aspec, cfg, shape: ShapeSpec, b: int):
    """(Trace, ids of the parameters, of the caches, of the batch) of one
    ``forward_tokens`` call: a prefill of ``shape.seq`` tokens, or one
    decode step at the cache's last row."""
    from repro_torch.analysis import _trace
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_leaves
    cfg = registry.serving_config(aspec, cfg, shape)
    mod = registry.family_module(aspec)
    params = mod.init(cfg, torch.Generator().manual_seed(0), device="meta")
    caches = mod.init_caches(b, cfg, device="meta")
    prefill = shape.kind == "prefill"
    t = shape.seq if prefill else 1
    batch = {"ids": torch.empty((b, t), dtype=torch.long, device="meta")}
    if prefill and aspec.family == "seamless":
        batch["src_frames"] = torch.empty((b, shape.seq, cfg.d_model),
                                          dtype=cfg.torch_dtype,
                                          device="meta")
    fwd = registry.make_forward_tokens(aspec, cfg)
    rec = _trace.Recorder()
    with rec:
        ids = [tuple(rec.tid(x) for x in tree_leaves(tree)
                     if isinstance(x, torch.Tensor))
               for tree in (params, caches, batch)]
        logits, _ = fwd(params, batch, caches, 0 if prefill
                        else shape.seq - 1)
        keep = (rec.tid(logits),)
    return _trace.Trace.of(rec), ids, keep


def lower_cell(arch_id: str, shape_name: str, ranks: int = 1, *,
               cfg_override=None, consumers=None, optimizer: str = "adamw",
               spec=None, profile: str = DEFAULT_PROFILE,
               shape: Optional[ShapeSpec] = None):
    """Record one cell; returns (CellResult, its record or None)."""
    from repro_torch.models import registry
    aspec = registry.get(arch_id)
    shape = shape if shape is not None else shape_spec(shape_name)
    res = CellResult(arch_id, shape.name, ranks, ok=False, profile=profile)
    if cfg_override is None and shape.name in SKIP.get(arch_id, ()):
        res.skipped, res.reason, res.ok = True, SKIP_REASON, True
        return res, None
    cfg = cfg_override if cfg_override is not None else aspec.full()
    t0 = time.time()
    if shape.kind == "train":
        if shape.batch % ranks:
            res.reason = (f"refused: {shape.batch} examples do not split "
                          f"over {ranks} data ranks (dist.pex takes "
                          f"B % N == 0)")
            return res, None
        tr, res.local_batch = record_train(aspec, cfg, shape.batch,
                                           shape.seq, ranks=ranks,
                                           consumers=consumers,
                                           optimizer=optimizer, spec=spec)
        live = train_liveness(tr)
        res.n_params = float(sum(
            math.prod(tr.tensors[t].shape) for t in tr.param_ids))
    else:
        res.local_batch = -(-shape.batch // ranks)
        tr, (pids, cids, bids), keep = record_serve(aspec, cfg, shape,
                                                    res.local_batch)
        live = liveness(tr, {"params": pids, "state": cids,
                             "batch": bids}, keep)
        res.n_params = float(sum(math.prod(tr.tensors[t].shape)
                                 for t in pids))
    res.record_s = time.time() - t0
    res.n_ops = len(tr.ops)
    res.flops, res.bytes_accessed = hlo.compiled_cost(tr)
    res.coll_bytes = hlo.collective_bytes(tr)
    res.coll_counts = hlo.collective_counts(tr)
    res.param_bytes_per_dev = live.resident["params"]
    res.state_bytes_per_dev = live.resident["state"]
    res.batch_bytes_per_dev = live.resident["batch"]
    res.other_bytes_per_dev = live.resident["other"]
    res.transient_peak_bytes = live.peak
    res.peak_bytes_per_dev = live.total
    res.peak_op = live.at
    res.fits = live.total <= get_profile(profile).hbm_bytes
    res.ok = True
    return res, tr


# ---------------------------------------------------------------------------
# the sharded mode
# ---------------------------------------------------------------------------

#: the reference's meshes: production, and its ``--smoke`` ones
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
SMOKE_MESHES = {False: ((4, 4), ("data", "model")),
                True: ((2, 4, 4), ("pod", "data", "model"))}


@contextlib.contextmanager
def recorded_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A world of prod(``shape``) ranks in this process on the ``fake``
    backend, and its mesh of ``shape`` over ``axes`` on the CPU."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.dist.sharding import make_mesh
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already up; a "
                           "recorded world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def tree_bytes_per_dev(leaves, axes, rules, extents: Dict[str, int],
                       dtype=None) -> float:
    """Analytic bytes a device holds of a tree (the reference's
    ``_tree_bytes_per_dev``): each leaf's bytes (in ``dtype`` where given)
    over the product of the mesh extents its logical ``axes`` resolve to
    under ``rules``. ``leaves`` are tensors (any device, ``meta`` too)."""
    from repro_torch.dist.sharding import spec, use_rules
    total = 0.0
    with use_rules(None, rules):
        for x, ax in zip(leaves, axes):
            size = torch.empty((), dtype=dtype or x.dtype).element_size()
            shards = 1
            for entry in spec(*ax):
                for a in (entry,) if isinstance(entry, str) \
                        else (entry or ()):
                    shards *= extents[a]
            total += math.prod(x.shape) * size / shards
    return total


def _meta_train_batch(aspec, cfg, b: int, s: int):
    """``registry.make_train_batch``'s leaves as ``meta`` tensors of a
    (``b``, ``s``) batch (nothing drawn)."""
    def m(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    batch = {"ids": m((b, s), torch.long), "labels": m((b, s), torch.long)}
    if aspec.family == "seamless":
        batch["src_frames"] = m((b, s, cfg.d_model), cfg.torch_dtype)
    if getattr(cfg, "vl_inputs", False):
        batch["vis_embeds"] = m((b, s, cfg.d_model), cfg.torch_dtype)
        batch["vis_mask"] = m((b, s), torch.bool)
        batch["positions"] = m((b, 3, s), torch.long)
    return batch


def cache_placements(aspec, cfg, path, x, mesh, shape: ShapeSpec,
                     multi_pod: bool):
    """The reference's ``_cache_shardings`` for one cache leaf of the
    port's per-layer layout (the reference's layer axes dropped) at key
    ``path``: (batch, time, KV heads, ...) over the data axes where the
    batch divides them, the time axis over ``data`` at 524k tokens and
    over ``model`` where the KV heads do not divide it."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.sharding import axis_size
    dp = ("pod", "data") if multi_pod else ("data",)
    b_ok = shape.batch % axis_size(dp, mesh) == 0
    dpa = dp if b_ok else None
    msz = axis_size("model", mesh)
    kv_ok = False
    if aspec.family == "transformer" and cfg.attn is not None:
        kv_ok = cfg.attn.n_kv % msz == 0
    if aspec.family in ("seamless", "zamba2"):
        kv_ok = cfg.kv_heads % msz == 0
    kv_ax = "model" if kv_ok else None
    if shape.name == "long_500k":
        seq_ax = ("data",) if kv_ok else ("data", "model")
    else:
        seq_ax = None if kv_ok else ("model",)
    keys = "/".join(map(str, path))
    nd = x.ndim
    if aspec.family == "transformer":
        base = (dpa, seq_ax, None) if ("ckv" in keys or "krope" in keys) \
            else (dpa, seq_ax, kv_ax, None)
    elif aspec.family == "rwkv6":
        base = (dpa,) + (None,) * (nd - 1)
    elif aspec.family == "zamba2":
        base = (dpa, seq_ax, kv_ax, None) if "shared" in keys \
            else (dpa,) + (None,) * (nd - 1)
    elif aspec.family == "seamless":
        base = (dpa, None, None) if "memory" in keys \
            else (dpa, seq_ax, kv_ax, None)
    else:
        raise ValueError(aspec.family)
    names = mesh.mesh_dim_names
    pl = [Replicate() for _ in names]
    for d, entry in enumerate(base[:nd]):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            pl[names.index(a)] = Shard(d)
    return pl


def _flat_pods(shape, axes, rules):
    """(mesh shape, axes, rules) the cell records on: the 2×16×16 mesh as
    32×16 over ("data", "model") where every rule names the pod axis only
    together with data, as ("pod", "data") — the same shards, and DTensor
    plans a redistribution over a 2-D mesh in a fraction of the time it
    takes over a 3-D one; otherwise as given."""
    if "pod" not in axes:
        return shape, axes, rules
    pair = ("pod", "data")
    flat = {}
    for k, v in rules.items():
        names = (v,) if isinstance(v, str) else tuple(v or ())
        if ("pod" in names or "data" in names) and names != pair:
            return shape, axes, rules
        flat[k] = "data" if names == pair else v
    ext = dict(zip(axes, shape))
    return (ext["pod"] * ext["data"], ext["model"]), ("data", "model"), flat


def lower_sharded(arch_id: str, shape_name: str, multi_pod: bool = False,
                  *, smoke: bool = False, cfg_override=None, consumers=None,
                  spec=None, profile: str = DEFAULT_PROFILE,
                  shape: Optional[ShapeSpec] = None):
    """Record one cell in the sharded mode (module docstring); returns
    (CellResult, its record or None)."""
    from repro_torch import pex
    from repro_torch.analysis import _trace
    from repro_torch.dist import sharding as shd
    from repro_torch.models import registry
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.nn.param import (axes_leaves, axes_of, tree_flatten,
                                      tree_leaves, tree_map, tree_paths,
                                      tree_unflatten)
    from repro_torch.optim import adamw
    aspec = registry.get(arch_id)
    shape = shape if shape is not None else shape_spec(shape_name)
    mshape, maxes = (SMOKE_MESHES if smoke else MESHES)[multi_pod]
    res = CellResult(arch_id, shape.name, math.prod(mshape), ok=False,
                     profile=profile, mode="sharded",
                     mesh="x".join(map(str, mshape)))
    if cfg_override is None and shape.name in SKIP.get(arch_id, ()):
        res.skipped, res.reason, res.ok = True, SKIP_REASON, True
        return res, None
    cfg = cfg_override if cfg_override is not None else aspec.full()
    if shape.kind != "train":
        cfg = registry.serving_config(aspec, cfg, shape)
    extents = dict(zip(maxes, mshape))
    rules = registry.rules_for(aspec, cfg, shape, multi_pod,
                               model_size=extents["model"],
                               data_size=extents["data"])
    mod = registry.family_module(aspec)
    t0 = time.time()
    rshape, raxes, rrules = _flat_pods(mshape, maxes, rules)
    with recorded_mesh(rshape, raxes) as mesh, shd.use_rules(mesh, rrules):
        params = mod.init(cfg, torch.Generator().manual_seed(0),
                          device="meta")
        axes = axes_leaves(axes_of(params))
        p_leaves = tree_leaves(params)
        res.n_params = float(sum(x.numel() for x in p_leaves))
        res.param_bytes_analytic = tree_bytes_per_dev(p_leaves, axes, rules,
                                                      extents)
        dparams = shd.distribute_tree(params, axes_of(params))
        del params
        rec = _trace.Recorder(mesh=mesh)
        if shape.kind == "train":
            n_micro = aspec.train_microbatches if cfg_override is None \
                else 1
            res.microbatches = n_micro
            if shape.batch % n_micro:
                raise ValueError(f"a batch of {shape.batch} does not split "
                                 f"into {n_micro} microbatches")
            mb = shape.batch // n_micro
            micro = [shd.distribute_batch(
                _meta_train_batch(aspec, cfg, mb, shape.seq), mesh)
                for _ in range(n_micro)]
            res.local_batch = micro[0]["ids"].to_local().shape[0] * n_micro
            # AdamW's moments: f32, laid out as their parameters
            res.state_bytes_analytic = 2 * tree_bytes_per_dev(
                p_leaves, axes, rules, extents, dtype=torch.float32)
            state = adamw.init(dparams)
            cons = list(consumers) if consumers is not None \
                else [pex.Norms(), pex.Grads()]
            eng = pex.Engine(spec)
            loss_fn = registry.make_loss_fn_v2(aspec, cfg)
            with rec:
                pids = [rec.tid(x) for x in tree_leaves(dparams)]
                oids = [rec.tid(x) for x in tree_leaves(state)
                        if isinstance(x, torch.Tensor)]
                bids = [rec.tid(x) for b in micro for x in tree_leaves(b)]
                grads, keep = None, []
                for b in micro:
                    r = eng.step(loss_fn, dparams, b, cons, batch_size=mb)
                    keep += [rec.tid(r.loss_vec)] + (
                        [rec.tid(r.sq_norms)] if r.sq_norms is not None
                        else [])
                    outs = [("loss_vec", "", rec.tid(r.loss_vec))] + (
                        [("sq_norms", "", rec.tid(r.sq_norms))]
                        if r.sq_norms is not None else []) + (
                        [("grads", "/".join(map(str, pth)), rec.tid(g))
                         for pth, g in zip(tree_paths(r.grads),
                                           tree_leaves(r.grads))]
                        if r.grads is not None else [])
                    if n_micro == 1:
                        grads = r.grads
                    elif grads is None:
                        grads = tree_map(lambda g: g.to(torch.float32),
                                         r.grads)
                    else:
                        for a, g in zip(tree_leaves(grads),
                                        tree_leaves(r.grads)):
                            a.add_(g.to(torch.float32))
                    del r
                adamw.update(adamw.AdamWConfig(), state, dparams, grads)
            tr = _trace.Trace.of(rec)
            live = liveness(tr, {"params": pids, "state": oids,
                                 "batch": bids}, keep + pids + oids)
            # the last microbatch's step against the collective schedule
            from repro_torch.analysis import collectives
            from repro_torch.core import plan as plan_mod
            res.collective_findings = [f.code for f in
                                       collectives.analyze_sharded(
                tr, outs, plan_mod.analyze(cons),
                dict(zip(raxes, rshape)))]
        else:
            caches = mod.init_caches(shape.batch, cfg, device="meta")
            cpaths = tree_paths(caches)
            c_leaves = tree_leaves(caches)
            pls = [cache_placements(aspec, cfg, pth, x, mesh, shape,
                                    "pod" in raxes)
                   for pth, x in zip(cpaths, c_leaves)]
            res.state_bytes_analytic = sum(
                x.numel() * x.element_size() / math.prod(
                    mesh.mesh.shape[i] for i, pl in enumerate(p)
                    if type(pl).__name__ == "Shard")
                for x, p in zip(c_leaves, pls))
            flat = [distribute_tensor(x, mesh, p, src_data_rank=None)
                    for x, p in zip(c_leaves, pls)]
            dcaches = tree_unflatten(tree_flatten(caches)[1], flat)
            prefill = shape.kind == "prefill"
            t = shape.seq if prefill else 1
            batch = {"ids": torch.empty((shape.batch, t), dtype=torch.long,
                                        device="meta")}
            if prefill and aspec.family == "seamless":
                batch["src_frames"] = torch.empty(
                    (shape.batch, shape.seq, cfg.d_model),
                    dtype=cfg.torch_dtype, device="meta")
            batch = shd.distribute_batch(batch, mesh)
            res.local_batch = batch["ids"].to_local().shape[0]
            fwd = registry.make_forward_tokens(aspec, cfg)
            with rec, shd.sharded_step(mesh, shd.batch_mesh_dims(mesh)):
                pids = [rec.tid(x) for x in tree_leaves(dparams)]
                cids = [rec.tid(x) for x in flat]
                bids = [rec.tid(x) for x in tree_leaves(batch)]
                logits, _ = fwd(dparams, batch, dcaches,
                                0 if prefill else shape.seq - 1)
                keep = [rec.tid(logits)]
            tr = _trace.Trace.of(rec)
            live = liveness(tr, {"params": pids, "state": cids,
                                 "batch": bids}, keep)
    res.record_s = time.time() - t0
    res.n_ops = len(tr.ops)
    res.flops, res.bytes_accessed = hlo.compiled_cost(tr)
    res.coll_bytes = hlo.collective_bytes(tr)
    res.coll_counts = hlo.collective_counts(tr)
    res.param_bytes_per_dev = live.resident["params"]
    res.state_bytes_per_dev = live.resident["state"]
    res.batch_bytes_per_dev = live.resident["batch"]
    res.other_bytes_per_dev = live.resident["other"]
    res.transient_peak_bytes = live.peak
    res.peak_bytes_per_dev = live.total
    res.peak_op = live.at
    res.fits = live.total <= get_profile(profile).hbm_bytes
    res.ok = True
    return res, tr


def _write(res: CellResult, out_dir, name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)
    status = "SKIP" if res.skipped else ("OK" if res.ok else "FAIL")
    where = f"{res.mesh} mesh" if res.mode == "sharded" \
        else f"{res.ranks} ranks"
    extra = ""
    if res.mode == "sharded" and res.ok and not res.skipped:
        extra = (f" params={res.param_bytes_per_dev / 1e9:.3f}GB/dev "
                 f"state={res.state_bytes_per_dev / 1e9:.3f}GB/dev "
                 f"micro={res.microbatches}")
    print(f"[{status}] {res.arch} × {res.shape} × {where} "
          f"record={res.record_s:.1f}s flops={res.flops:.3g} "
          f"coll={res.coll_bytes.get('total', 0):.3g}B "
          f"peak={res.peak_bytes_per_dev / 1e9:.2f}GB/dev "
          f"fits={res.fits}{extra}"
          + (f" ({res.reason})" if res.reason else ""))
    if res.error:
        print(res.error)


def run_cell(arch_id, shape_name, ranks, out_dir=None, **kw) -> CellResult:
    """One ``--pex-spmd`` cell over ``ranks`` data ranks."""
    try:
        res, _ = lower_cell(arch_id, shape_name, ranks, **kw)
    except Exception:
        res = CellResult(arch_id, shape_name, ranks, ok=False,
                         error=traceback.format_exc()[-2000:])
    _write(res, out_dir, f"{arch_id}__{shape_name}__{ranks}")
    return res


def run_sharded(arch_id, shape_name, multi_pod=False, out_dir=None,
                **kw) -> CellResult:
    """One sharded cell. A train cell's parameter and state bytes (every
    leaf of both is read by the update) are held to the analytic figures:
    a record that holds other bytes fails. A serve cell's record holds
    the leaves it reads (a decode step does not read seamless's encoder)."""
    mesh = "x".join(map(str, ((SMOKE_MESHES if kw.get("smoke")
                               else MESHES)[multi_pod][0])))
    try:
        res, _ = lower_sharded(arch_id, shape_name, multi_pod, **kw)
        if res.ok and not res.skipped and res.microbatches and (
                shape_spec(shape_name).kind == "train") and (
                res.param_bytes_per_dev != res.param_bytes_analytic
                or res.state_bytes_per_dev != res.state_bytes_analytic):
            res.ok = False
            res.error = (f"per-device bytes: params "
                         f"{res.param_bytes_per_dev} recorded against "
                         f"{res.param_bytes_analytic} analytic, state "
                         f"{res.state_bytes_per_dev} against "
                         f"{res.state_bytes_analytic}")
    except Exception:
        res = CellResult(arch_id, shape_name, 0, ok=False, mode="sharded",
                         mesh=mesh, error=traceback.format_exc()[-2000:])
    _write(res, out_dir, f"{arch_id}__{shape_name}__{mesh}")
    return res


def main(argv=None):
    from repro_torch.models import registry
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--ranks", type=int, action="append", default=[],
                    help="--pex-spmd: data ranks of the recorded mesh "
                         "(repeatable; default 256)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="where each cell's JSON goes (default "
                         "build/dryrun; none under --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs at the smoke shapes: on (4, 4), "
                         "(2, 4, 4) with --multi-pod; 1 and 4 ranks with "
                         "--pex-spmd (the CPU regression run)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--pex-spmd", action="store_true",
                    help="the data-only mesh path (dist.pex) instead of "
                         "the sharded default")
    args = ap.parse_args(argv)
    archs = sorted(registry.ARCHS) if args.all or not args.arch \
        else args.arch
    results = []
    if not args.pex_spmd:
        if args.smoke:
            for arch in archs:
                cfg = registry.get(arch).smoke()
                for shp in _EXTRA_SHAPES:
                    results.append(run_sharded(arch, shp, args.multi_pod,
                                               args.out, smoke=True,
                                               cfg_override=cfg))
        else:
            shapes = list(SHAPES) if args.all or not args.shape \
                else args.shape
            for arch in archs:
                for shp in shapes:
                    results.append(run_sharded(arch, shp, args.multi_pod,
                                               args.out or "build/dryrun"))
    elif args.smoke:
        for arch in archs:
            cfg = registry.get(arch).smoke()
            for shp in _EXTRA_SHAPES:
                for n in args.ranks or [1, 4]:
                    results.append(run_cell(arch, shp, n, args.out,
                                            cfg_override=cfg))
    else:
        shapes = list(SHAPES) if args.all or not args.shape else args.shape
        for arch in archs:
            for shp in shapes:
                for n in args.ranks or [256]:
                    results.append(run_cell(arch, shp, n,
                                            args.out or "build/dryrun"))
    bad = [r for r in results if not r.ok and not r.reason]
    print(f"\n{sum(r.ok for r in results)}/{len(results)} cells recorded "
          f"({sum(r.skipped for r in results)} documented skips, "
          f"{sum(bool(r.reason) and not r.skipped for r in results)} "
          f"refused)")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
