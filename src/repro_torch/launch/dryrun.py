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

A train cell runs the **data-only** mesh path (the reference's
``--pex-spmd`` mode: ``dist.pex`` with per-rank norms and one gradient
all-reduce), the one the port has — model axes of extent > 1 are refused
by ``dist.pex``. Each rank holds the local batch B/N, the parameters
replicated, and the optimizer state. The N-rank world exists only as a
recorded mesh: ``torch.distributed``'s ``fake`` process-group backend
(``torch.testing._internal.distributed.fake_pg``) makes an N-rank world in
this one process, and rank 0's record is the cell's; no process is
spawned, and no collective is sent (a trace records ``dist.pex``'s
all-reduces). One rank runs the local path, as a single card does. Where
the batch does not split over the ranks the cell is refused, as
``dist.pex`` refuses it. The reference's sharding rules put the
parameters' model axes over 16 cards; here they stay replicated, and a
cell that does not fit so reads ``fits: false``.

A serve cell (prefill, decode) records one ``forward_tokens`` call of the
local requests (ceil(B/N): each rank is a replica serving its own) against
caches of the shape's length.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --ranks 256 [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke
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


def run_cell(arch_id, shape_name, ranks, out_dir=None, **kw) -> CellResult:
    try:
        res, _ = lower_cell(arch_id, shape_name, ranks, **kw)
    except Exception:
        res = CellResult(arch_id, shape_name, ranks, ok=False,
                         error=traceback.format_exc()[-2000:])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch_id}__{shape_name}__{ranks}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)
    status = "SKIP" if res.skipped else ("OK" if res.ok else "FAIL")
    print(f"[{status}] {arch_id} × {shape_name} × {ranks} ranks "
          f"record={res.record_s:.1f}s flops={res.flops:.3g} "
          f"coll={res.coll_bytes.get('total', 0):.3g}B "
          f"peak={res.peak_bytes_per_dev / 1e9:.2f}GB/dev "
          f"fits={res.fits}" + (f" ({res.reason})" if res.reason else ""))
    if res.error:
        print(res.error)
    return res


def main(argv=None):
    from repro_torch.models import registry
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--ranks", type=int, action="append", default=[],
                    help="data ranks of the recorded mesh (repeatable; "
                         "default 256)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs at the smoke shapes, 1 and 4 ranks "
                         "(the CPU regression run)")
    args = ap.parse_args(argv)
    archs = sorted(registry.ARCHS) if args.all or not args.arch \
        else args.arch
    results = []
    if args.smoke:
        for arch in archs:
            cfg = registry.get(arch).smoke()
            for shp in _EXTRA_SHAPES:
                for n in args.ranks or [1, 4]:
                    results.append(run_cell(arch, shp, n, cfg_override=cfg))
    else:
        shapes = list(SHAPES) if args.all or not args.shape else args.shape
        for arch in archs:
            for shp in shapes:
                for n in args.ranks or [256]:
                    results.append(run_cell(arch, shp, n, out_dir=args.out))
    bad = [r for r in results if not r.ok and not r.reason]
    print(f"\n{sum(r.ok for r in results)}/{len(results)} cells recorded "
          f"({sum(r.skipped for r in results)} documented skips, "
          f"{sum(bool(r.reason) and not r.skipped for r in results)} "
          f"refused)")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
