"""HBM-traffic attribution over a full *training* step — the static half
of the paper's overhead claim ("pexcost", DESIGN.md §13).

Port of ``src/repro/analysis/traffic.py``. The paper's value proposition
is a cost statement: per-example norms ride along with one backward at
little extra traffic. This pass states it over the whole step —
``plan.execute`` / ``dist.pex.plan_step`` **plus** the optimizer apply
(the noise add, the global-norm clip, the AdamW or Adafactor update),
which no other pass covers — on a record of the step
(``_trace.trace_train_step``).

Each record is labelled with a **phase** — forward / activation-bwd /
weight-bwd / stats / apply — from taint lineage, as the reference labels
its equations: the ``grad_leaf`` marks ``plan.execute`` plants at the
plan/apply boundary, the backward seeds' ``grad_seed`` marks, the
optimizer state and the noise samples; and from which of the step's
outputs each record feeds (a reverse sweep over the record).

**Eager, not fused.** The reference models XLA fusion (elementwise chains
merged into components) so that its "materialized bytes" are the bytes
that cross HBM. PyTorch eager fuses nothing: every op reads its operands
from HBM and writes its results there, so this pass charges every aten op
its operands and results — each distinct tensor once, at its distinct
elements (a broadcast axis is read once) — except views, which move
nothing. An in-place op reads and writes its target, except that
``copy_``, ``fill_`` and ``zero_`` only write it and an indexed op
(``index_add_``, ``index_put_``, ``scatter_add_``, ...) reads and writes
only the target's elements its index reaches. A hand-written
kernel's site enters through its launch contract
(``kernels.ops.contract_for_launch``: ``flops`` and ``hbm_bytes()``, the
function's least work and the rows a launch keeps), never through the
``meta`` outputs the recorder made for it. The fusion components of the
reference are replaced by this rule by design.

Flops follow the reference's convention (``eqn_flops``): 2·M·N·K for a
contraction (from ``torch.utils.flop_counter``'s registry, recorded at the
op), one per float output element of an elementwise op (the ops torch
tags ``pointwise``, and dtype converts), one per input element of a
reduction, zero for data movement.

**Gradient streams.** A stream is one pass over a whole gradient leaf:
an apply-phase op (not a view, not a dtype convert) that reads a tensor
carrying the leaf's ``g:i`` taint adds that tensor's elements over the
leaf's; a loop over the 2^26-element chunks of one leaf
(``optim.adamw.CHUNK``) that applies the same op so adds up to one stream,
not one per chunk. The pass reports the most any leaf takes.

Findings:

  * ``redundant-hbm-stream`` — more full-gradient passes than the plan and
    the optimizer's own code make (``expected_streams``); the count they
    make today is reported apart, allowlisted, against the fused apply of
    ROADMAP.md Queue 2b row 0;
  * ``duplicate-forward`` — forward-phase flops above the plain forward of
    the same model (× the importance-region factor);
  * ``dead-residual`` — a two-backward plan whose reweighted backward (the
    one that forms the returned gradients) reads forward residuals that
    neither the loss nor the norms came from (a second forward linearized
    again);
  * ``upcast-materialization`` — a widening dtype copy of a whole gradient
    leaf read by more than one op (a copy of the tree kept, where the
    reference's rule lets a cast ride into its one consumer).

Trace-only: a record on ``meta`` tensors and pure-Python bookkeeping.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import _trace as _T
from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.core.provenance import TAG_GLEAF, TAG_NOISE, TAG_SEED

PASS = "traffic"
EMPTY = _T.EMPTY

#: taint tokens
T_PARAM = "p"
T_OPT = "opt"
T_BATCH = "b"
T_KEY = "key"
T_NOISEKEY = "nz"       # a DP noise sample

#: phases, in attribution priority order
PH_APPLY = "apply"
PH_STATS = "stats"
PH_WEIGHT = "weight-bwd"
PH_ACT = "activation-bwd"
PH_FWD = "forward"
PHASES = (PH_FWD, PH_ACT, PH_WEIGHT, PH_STATS, PH_APPLY)

#: reductions: one flop per input element
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "any", "all", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
})
#: dtype converts: elementwise for flops, but a cast, not a stream
_CONVERT = frozenset({"_to_copy"})
#: allocations that write nothing
_EMPTY_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})
#: in-place ops that overwrite their target without reading it
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})
#: indexed in-place ops, by the position in ``Op.ins`` of the operand whose
#: elements count the target's elements touched (each read and written:
#: every such op in the port accumulates); ``None``: ``index_put_``'s
#: index tensors, broadcast, times the target's unindexed trailing axes
_INDEXED = {"index_add_": 2, "index_copy_": 2, "scatter_": 1,
            "scatter_add_": 1, "scatter_reduce_": 1, "index_put_": None,
            "_index_put_impl_": None}

#: duplicate-forward fires above this multiple of the expected forward
FWD_TOL = 1.5
#: dead-residual fires below this shared fraction of residual bytes
RESIDUAL_TOL = 0.25

#: full-gradient passes each optimizer's own update makes, counted in the
#: port's code by the rule above (ops on chunks of one leaf add up to one;
#: dtype converts are casts, not streams):
#:
#:   * AdamW (``optim/adamw.update``'s chunk loop) makes 15: the scale
#:     ``g·s``, ``(1−β1)·g``, the m add, ``g²``, ``(1−β2)·g²``, the v add,
#:     then over the gradient-derived moments ``m/c1``, ``v/c2``, the sqrt,
#:     ``+ε``, the quotient, ``+ wd·p``, ``lr·δ``, ``p − lr·δ`` and the
#:     parameter write (``copy_``);
#:   * Adafactor (``optim/adafactor.update``) makes 13 on a factored leaf:
#:     ``g²``, ``+ε1``, its row and column means, ``+ε1`` on the factored
#:     ``r·vc`` (a product of small vectors that writes a leaf-sized
#:     array), the rsqrt, ``g·rsqrt(·)``, the RMS clip's square and mean,
#:     its rescale, ``lr·s·u``, ``p − ·`` and the write.
#:
#: The global-norm clip adds 2 (the square and the sum of
#: ``adamw.global_norm``), the DP noise add 1 (its in-place add).
_OPT_STREAMS = {"adamw": 15, "adafactor": 13}
_CLIP_STREAMS = 2
_NOISE_STREAMS = 1


@functools.lru_cache(maxsize=None)
def _aten(name: str):
    """The OpOverload a record's name (``aten.mul.Tensor``) names."""
    ns, op, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, ns), op), overload)


@functools.lru_cache(maxsize=None)
def _op_class(name: str) -> str:
    """'reduce' | 'pointwise' | 'convert' | 'empty' | 'move' of an aten
    op, by its name and torch's tags."""
    op = name.split(".")[1]
    if op in _REDUCE:
        return "reduce"
    if op in _CONVERT:
        return "convert"
    if op in _EMPTY_OPS:
        return "empty"
    try:
        tags = _aten(name).tags
    except (AttributeError, ValueError):
        return "move"
    return "pointwise" if torch.Tag.pointwise in tags else "move"


def _numel(info: _T.TensorInfo) -> int:
    n = 1
    for d in info.shape:
        n *= int(d)
    return n


def _is_float(info: _T.TensorInfo) -> bool:
    return info.dtype in ("float32", "bfloat16", "float16", "float64")


def _itemsize(info: _T.TensorInfo) -> int:
    return getattr(torch, info.dtype).itemsize


def _touched(op: _T.Op, tensors) -> int:
    """The elements of an indexed in-place op's target that it reaches."""
    target = tensors[op.ins[0]]
    pos = _INDEXED[op.name.split(".")[1]]
    if pos is not None:
        return min(_numel(tensors[op.ins[pos]]), _numel(target))
    idx = [tensors[t].shape for t in op.ins[1:-1]]
    n = math.prod(torch.broadcast_shapes(*idx)) \
        * math.prod(target.shape[len(idx):])
    return min(n, _numel(target))


def is_view(op: _T.Op, tensors) -> bool:
    """An aten op that returns a view of an operand: an output on an
    input's storage, written by nothing."""
    if op.kind != "aten" or op.writes:
        return False
    ins = {tensors[t].storage for t in op.ins}
    return any(tensors[t].storage in ins for t in op.outs)


def kernel_contracts(op: _T.Op) -> list:
    """The launch contracts of one recorded kernel site."""
    from repro_torch.kernels import ops
    m = dict(op.meta)
    return ops.contract_for_launch(op.name, **m)


def op_cost(op: _T.Op, tensors) -> Tuple[float, float]:
    """(flops, bytes) of one record (module docstring's rules)."""
    if op.kind == "kernel":
        cs = kernel_contracts(op)
        return (float(sum(c.flops for c in cs)),
                float(sum(c.hbm_bytes() for c in cs)))
    if op.kind == "collective":
        b = float(tensors[op.ins[0]].nbytes)
        return 0.0, 2.0 * b
    if op.kind == "draw":
        return 0.0, float(sum(tensors[t].nbytes for t in op.outs))
    if op.kind != "aten" or is_view(op, tensors):
        return 0.0, 0.0
    cls = _op_class(op.name)
    if cls == "empty":
        return 0.0, 0.0
    name = op.name.split(".")[1]
    if name in _WRITE_ONLY or name in _INDEXED:
        reads = sum(tensors[t].nbytes for t in dict.fromkeys(op.ins)
                    if t not in op.outs)
        target = tensors[op.ins[0]]
        nbytes = float(reads + (target.nbytes if name in _WRITE_ONLY else
                                2 * _touched(op, tensors) * _itemsize(target)))
    else:
        nbytes = float(sum(tensors[t].nbytes for t in dict.fromkeys(op.ins))
                       + sum(tensors[t].nbytes
                             for t in dict.fromkeys(op.outs)))
    if op.meta and "flops" in op.meta:
        return float(op.meta["flops"]), nbytes
    if cls in ("pointwise", "convert") and op.outs:
        out = tensors[op.outs[0]]
        return (float(_numel(out)) if _is_float(out) else 0.0), nbytes
    if cls == "reduce" and op.ins:
        return float(_numel(tensors[op.ins[0]])), nbytes
    return 0.0, nbytes


def contraction_flops(op: _T.Op) -> float:
    """The flops of a contraction record (0 for any other)."""
    if op.kind == "aten" and op.meta and "flops" in op.meta:
        return float(op.meta["flops"])
    return 0.0


def program_cost(trace: _T.Trace) -> Tuple[float, float]:
    """(flops, bytes) of a whole record."""
    f = b = 0.0
    for op in trace.ops:
        df, db = op_cost(op, trace.tensors)
        f += df
        b += db
    return f, b


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

class _TrafficWalker(_T.Walker):
    """Taint propagation for the traffic pass: ``p`` parameters, ``opt``
    optimizer state, ``b`` batch, ``key`` draws, ``nz`` noise samples,
    ``seed:<kind>`` backward seeds, ``g:<i>`` gradient leaf i (from the
    plan/apply boundary marks). ``g:*`` is stripped at scalar outputs so
    a global-norm scalar does not smear every leaf's token over the whole
    apply. Each record's operand taints are kept (``in_taints``)."""

    def __init__(self):
        self.in_taints: List[List[frozenset]] = []
        self.gleaf_sizes: Dict[int, int] = {}

    def taint(self, tid: int) -> frozenset:
        """A tensor's own taint: an in-place write taints the tensor it
        writes (an op's output), not every view of its storage — so
        AdamW's write of one chunk of a moment does not taint the
        leaf's other chunks, read after it."""
        t = self.env.get(tid)
        if t is None:
            t = self.senv.get(self._storage(tid), EMPTY)
        return t

    def hook(self, op, in_t):
        self.in_taints.append(in_t)
        if op.kind == "mark" and op.ins:
            meta = op.meta or {}
            t = in_t[0]
            if op.name == TAG_GLEAF:
                leaf = int(meta.get("leaf", -1))
                t = t | {f"g:{leaf}"}
                self.gleaf_sizes[leaf] = _numel(self.tensors[op.ins[0]])
            elif op.name == TAG_SEED:
                t = t | {f"seed:{meta.get('kind', '?')}"}
            elif op.name == TAG_NOISE:
                t = t | {T_NOISEKEY}
            return [t]
        u = frozenset().union(*in_t) if in_t else EMPTY
        if op.kind == "draw":
            u = u | {T_KEY}
        stripped = frozenset(t for t in u if not t.startswith("g:"))
        return [stripped if _numel(self.tensors[o]) <= 1 else u
                for o in op.outs]


def _needed_by(trace: _T.TrainTrace) -> List[frozenset]:
    """Which output fields each record feeds: a reverse sweep over the
    record, by storage (an in-place write feeds whoever reads the storage
    after it)."""
    tensors = trace.tensors
    fields: Dict[int, frozenset] = {}
    for field, _path, tid in trace.outputs:
        s = tensors[tid].storage
        fields[s] = fields.get(s, EMPTY) | {field}
    out: List[frozenset] = [EMPTY] * len(trace.ops)
    for op in reversed(trace.ops):
        g = EMPTY
        for t in op.outs:
            g = g | fields.get(tensors[t].storage, EMPTY)
        for s in op.writes:
            g = g | fields.get(s, EMPTY)
        out[op.index] = g
        if g:
            for t in op.ins:
                s = tensors[t].storage
                fields[s] = fields.get(s, EMPTY) | g
    return out


#: batched contractions: their leading axis is never summed over
_BATCHED = frozenset({"bmm", "baddbmm"})


def _carries_batch(op: _T.Op, info: _T.TensorInfo,
                   rows: Tuple[int, ...]) -> bool:
    """Does an op's output keep the batch's rows: an axis of B or B·S, or
    — for a batched contraction, whose batch axis folds the examples with
    the heads (B·H) — a leading axis that is a multiple of B? (The
    reference reads the unfolded axes of its einsums; a folded batch axis
    whose extent another factor of B also divides, an expert count, is
    read as rows here.)"""
    if any(int(d) in rows for d in info.shape):
        return True
    return (op.kind == "aten" and op.name.split(".")[1] in _BATCHED
            and bool(info.shape) and int(info.shape[0]) % rows[0] == 0)


def _phase(op: _T.Op, union: frozenset, groups: frozenset,
           tensors, rows: Tuple[int, ...], stat_elems: int) -> str:
    if any(t.startswith("g:") for t in union) or T_OPT in union \
            or T_NOISEKEY in union:
        return PH_APPLY
    seeds = {t for t in union if t.startswith("seed:")}
    if not seeds:
        # parameter/batch-only work that does not feed the loss is either
        # norms-only statistics or a backward's recompute of a checkpointed
        # block — charged to the phase that demanded it, as the reference
        # charges its remat; a recompute's op that feeds nothing (the
        # accumulator's copies) is still the backward's
        if (groups and "loss_vec" not in groups) or op.remat:
            if groups and groups <= frozenset({"sq_norms", "gns"}):
                return PH_STATS
            return PH_ACT
        return PH_FWD
    if groups and groups <= frozenset({"sq_norms", "gns", "loss_vec"}):
        return PH_STATS
    if not op.outs:
        return PH_ACT
    out = tensors[op.outs[0]]
    if "seed:norms" in seeds and _numel(out) <= stat_elems:
        return PH_STATS
    if not _carries_batch(op, out, rows):
        return PH_WEIGHT
    return PH_ACT


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Traffic attribution of one recorded training step. ``flops``
    counts every pass of every layer (the port's layers run in a Python
    loop; the reference's second count, loop bodies once, has no
    counterpart); ``kernel_flops`` and
    ``kernel_bytes`` are the share of the kernel sites' contracts in
    ``flops`` and ``hbm_bytes``; ``phase_contraction_flops`` the
    contractions' flops by phase."""
    granularity: str
    optimizer: str
    plan_desc: str
    n_leaves: int
    flops: float
    hbm_bytes: float            # every op's operands and results (eager)
    coll_bytes: float           # all-reduce operand bytes
    phase_flops: Tuple[Tuple[str, float], ...]
    phase_bytes: Tuple[Tuple[str, float], ...]
    n_streams: int              # full-gradient HBM passes after the plan
    expected_streams: int       # what the plan + optimizer code make
    forward_flops: float
    ref_forward_flops: float
    residual_sharing: float     # [0, 1]; -1 when not applicable
    findings: Tuple[Finding, ...]
    allowlisted: Tuple[Finding, ...]    # known waste, tracked not failed
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    phase_contraction_flops: Tuple[Tuple[str, float], ...] = ()

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        ph = ", ".join(f"{k}={v / 1e6:.1f}MB"
                       for k, v in self.phase_bytes if v)
        head = (f"traffic[{self.granularity}/{self.optimizer}]: "
                f"{self.flops:.3g} flops, "
                f"{self.hbm_bytes / 1e6:.1f} MB through HBM ({ph}); "
                f"gradient streams {self.n_streams} "
                f"(expected {self.expected_streams}, "
                f"{len(self.allowlisted)} allowlisted)")
        return "\n".join([head] + [f"  {f.render()}" for f in
                                   self.findings + self.allowlisted])

    def to_json(self) -> dict:
        return {
            "granularity": self.granularity, "optimizer": self.optimizer,
            "plan": self.plan_desc, "n_leaves": self.n_leaves,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
            "phase_flops": dict(self.phase_flops),
            "phase_bytes": dict(self.phase_bytes),
            "phase_contraction_flops": dict(self.phase_contraction_flops),
            "n_streams": self.n_streams,
            "expected_streams": self.expected_streams,
            "forward_flops": self.forward_flops,
            "ref_forward_flops": self.ref_forward_flops,
            "residual_sharing": self.residual_sharing,
            "findings": [f.to_json() for f in self.findings],
            "allowlisted": [f.to_json() for f in self.allowlisted],
        }


def expected_streams(plan, optimizer: str,
                     global_clip: Optional[float]) -> int:
    """Full-gradient HBM passes the port's apply makes by its code: the
    optimizer's update (``_OPT_STREAMS``), its global-norm clip, and the DP
    noise add. A fused apply (ROADMAP.md Queue 2b row 0) brings these to
    one."""
    if optimizer == "none" or not plan.needs_grads:
        return 0
    n = _OPT_STREAMS.get(optimizer, 1)
    if global_clip is not None:
        n += _CLIP_STREAMS
    if plan.noise is not None:
        n += _NOISE_STREAMS
    return n


@dataclasses.dataclass
class Walk:
    """The labelled record of one step: each record's phase, cost, operand
    taints and the output fields it feeds."""
    trace: _T.TrainTrace
    phases: List[str]
    costs: List[Tuple[float, float]]
    in_taints: List[List[frozenset]]
    groups: List[frozenset]
    gleaf_sizes: Dict[int, int]


def label(trace: _T.TrainTrace) -> Walk:
    """Walk one recorded training step and label every record (phase,
    cost), its parameter, optimizer-state and batch leaves tainted by the
    ids the trace carries."""
    tensors = trace.tensors
    seed: Dict[int, frozenset] = {}
    for ids, tok in ((trace.param_ids, T_PARAM), (trace.opt_ids, T_OPT),
                     (trace.batch_ids, T_BATCH)):
        for tid in ids:
            seed[tid] = frozenset({tok})
    walker = _TrafficWalker()
    walker.run(trace, seed)
    groups = _needed_by(trace)
    b = trace.batch_size
    s = trace.seq
    rows = tuple(sorted({b} | ({b * s} if s else set())))
    stat_elems = b * max(s or 1, 64)
    phases, costs = [], []
    first_reader: Dict[int, int] = {}
    for op in trace.ops:
        for t in op.ins:
            first_reader.setdefault(tensors[t].storage, op.index)
    for op, in_t in zip(trace.ops, walker.in_taints):
        union = frozenset().union(*in_t) if in_t else EMPTY
        phases.append(_phase(op, union, groups[op.index], tensors, rows,
                             stat_elems))
        costs.append(op_cost(op, tensors))
    # an op that reads no tensor (a fresh zeros, a draw) belongs to the
    # phase of the first op that reads what it made
    for op in trace.ops:
        if not op.ins and op.outs:
            k = first_reader.get(tensors[op.outs[0]].storage)
            if k is not None and k > op.index:
                phases[op.index] = phases[k]
    return Walk(trace, phases, costs, walker.in_taints, groups,
                walker.gleaf_sizes)


def _streams(w: Walk) -> Dict[int, float]:
    """Passes over each gradient leaf made by apply-phase ops (module
    docstring)."""
    tensors = w.trace.tensors
    passes = {i: 0.0 for i in w.gleaf_sizes}
    for op, ph, in_t in zip(w.trace.ops, w.phases, w.in_taints):
        if ph != PH_APPLY or op.kind not in ("aten", "kernel") \
                or is_view(op, tensors) \
                or (op.kind == "aten" and _op_class(op.name) == "convert"):
            continue
        best: Dict[int, int] = {}
        for tid, t in zip(op.ins, in_t):
            n = _numel(tensors[tid])
            if n <= 1:
                continue
            for tok in t:
                if tok.startswith("g:"):
                    i = int(tok[2:])
                    if i in passes:
                        best[i] = max(best.get(i, 0), n)
        for i, n in best.items():
            passes[i] += n / w.gleaf_sizes[i]
    return passes


def _readers(trace: _T.Trace) -> Dict[int, int]:
    """Non-view ops reading each storage."""
    out: Dict[int, int] = {}
    for op in trace.ops:
        if op.kind != "aten" or is_view(op, trace.tensors):
            continue
        for s in {trace.tensors[t].storage for t in op.ins}:
            out[s] = out.get(s, 0) + 1
    return out


_WIDTH = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def analyze_trace(trace: _T.TrainTrace, *,
                  allow_known_streams: bool = True) -> TrafficReport:
    """Run the traffic pass on one ``TrainTrace``."""
    plan = trace.plan
    w = label(trace)
    tensors = trace.tensors

    phase_flops = {ph: 0.0 for ph in PHASES}
    phase_bytes = {ph: 0.0 for ph in PHASES}
    phase_cf = {ph: 0.0 for ph in PHASES}
    k_flops = k_bytes = coll = 0.0
    for op, ph, (f, b) in zip(trace.ops, w.phases, w.costs):
        phase_flops[ph] += f
        phase_bytes[ph] += b
        phase_cf[ph] += contraction_flops(op)
        if op.kind == "kernel":
            k_flops += f
            k_bytes += b
        elif op.kind == "collective":
            coll += tensors[op.ins[0]].nbytes
    flops = sum(phase_flops.values())
    hbm = sum(phase_bytes.values())

    # -- gradient streams --------------------------------------------------
    passes = _streams(w)
    counts = {i: int(round(p)) for i, p in passes.items()}
    n_streams = max(counts.values(), default=0)
    expected = expected_streams(plan, trace.optimizer, trace.global_clip)
    findings: List[Finding] = []
    allowlisted: List[Finding] = []
    worst = max(counts, key=counts.get, default=None)
    worst_label = trace.param_labels[worst] \
        if worst is not None and worst < len(trace.param_labels) else None
    if n_streams > expected:
        findings.append(Finding(
            PASS, ERROR, "redundant-hbm-stream",
            f"{n_streams} full-gradient HBM streams after the plan "
            f"boundary where the plan + {trace.optimizer} apply make "
            f"{expected}: an extra pass over every gradient leaf is "
            f"{n_streams - expected} more reads of the whole tree than the "
            f"step's code needs", leaf=worst_label))
    elif n_streams == expected and expected > 1:
        parts = []
        if plan.noise is not None:
            parts.append("noise add")
        if trace.global_clip is not None:
            parts.append("global-norm clip")
        parts.append(f"{trace.optimizer} update")
        f = Finding(
            PASS, ERROR, "redundant-hbm-stream",
            f"the apply path streams every gradient {n_streams}× "
            f"({', '.join(parts)}: each eager elementwise op re-reads the "
            f"leaf) — the known unfused-apply waste; see ROADMAP.md Queue "
            f"2b row 0 (a fused apply, one HBM pass per leaf)",
            leaf=worst_label)
        (allowlisted if allow_known_streams else findings).append(f)

    # -- duplicate forward -------------------------------------------------
    fwd_flops = phase_flops[PH_FWD]
    ref_flops = 0.0
    if trace.reference is not None:
        ref_flops, _ = program_cost(trace.reference)
        factor = 1.0
        if plan.importance is not None:
            factor += plan.importance.k / float(trace.batch_size)
        if ref_flops > 0 and fwd_flops > FWD_TOL * factor * ref_flops:
            findings.append(Finding(
                PASS, ERROR, "duplicate-forward",
                f"forward-phase flops ({fwd_flops:.3g}) are "
                f"{fwd_flops / ref_flops:.2f}× the plain forward "
                f"({ref_flops:.3g}); the fused plan owes exactly one "
                f"forward ({factor:.1f} regions expected) — a consumer "
                f"is re-running the model"))

    # -- residual sharing --------------------------------------------------
    sharing = -1.0
    if plan.n_backwards == 2 and plan.importance is None:
        # residuals: what seed-free ops made from the parameters or the
        # batch. Those of the forward the loss or the norms came from, and
        # what a backward recomputes from them (a chunked recurrence's
        # states), are shared; a second forward, made from the inputs
        # alone for outputs neither the loss nor the norms need, is not
        fwd_out: Dict[int, Tuple[float, bool]] = {}
        first_made: set = set()
        for op, ph, in_t in zip(trace.ops, w.phases, w.in_taints):
            union = frozenset().union(*in_t) if in_t else EMPTY
            if ph == PH_APPLY or not union & {T_PARAM, T_BATCH} \
                    or any(t.startswith("seed:") for t in union) \
                    or is_view(op, tensors):
                continue
            first = bool(w.groups[op.index] & {"loss_vec", "sq_norms"}) \
                or any(tensors[t].storage in first_made for t in op.ins)
            for t in op.outs:
                info = tensors[t]
                if first:
                    first_made.add(info.storage)
                if _numel(info) > trace.batch_size:
                    fwd_out.setdefault(info.storage,
                                       (float(info.nbytes), first))
        read: Dict[int, Tuple[float, bool]] = {}
        weighted = False
        for op, in_t in zip(trace.ops, w.in_taints):
            union = frozenset().union(*in_t) if in_t else EMPTY
            # the reweighted backward that forms the returned gradients
            # (eager runs a dead one too; the reference's DCE drops it)
            if "seed:weighted" not in union \
                    or "grads" not in w.groups[op.index]:
                continue
            weighted = True
            for t in op.ins:
                s = tensors[t].storage
                if s in fwd_out:
                    read[s] = fwd_out[s]
        if weighted:
            total = sum(b for b, _ in read.values())
            shared = sum(b for b, first in read.values() if first)
            sharing = shared / total if total > 0 else 0.0
            if sharing < RESIDUAL_TOL:
                findings.append(Finding(
                    PASS, ERROR, "dead-residual",
                    f"the reweighted backward reads {total / 1e6:.1f} MB "
                    f"of forward activations but only {sharing:.0%} of "
                    f"them come from the forward the loss and the norms "
                    f"were taken from — the two backwards are not running "
                    f"over one forward's residuals (a second linearization "
                    f"doubles residual traffic)"))

    # -- upcast materialization ---------------------------------------------
    readers = _readers(trace)
    sizes = set(w.gleaf_sizes.values())
    for op, ph, in_t in zip(trace.ops, w.phases, w.in_taints):
        if ph != PH_APPLY or op.kind != "aten" \
                or _op_class(op.name) != "convert" or not op.ins:
            continue
        src, dst = tensors[op.ins[0]], tensors[op.outs[0]]
        if _WIDTH.get(dst.dtype, 0) <= _WIDTH.get(src.dtype, 9):
            continue
        if _numel(src) in sizes and any(t.startswith("g:")
                                        for t in in_t[0]) \
                and readers.get(dst.storage, 0) > 1:
            findings.append(Finding(
                PASS, ERROR, "upcast-materialization",
                f"a {dst.dtype} copy of a {src.dtype} gradient leaf is "
                f"materialized and read {readers[dst.storage]} times — "
                f"upcast inside the consumer instead of copying the tree"))
            break

    return TrafficReport(
        granularity=trace.granularity, optimizer=trace.optimizer,
        plan_desc=plan.describe(), n_leaves=len(trace.param_labels),
        flops=flops, hbm_bytes=hbm, coll_bytes=coll,
        phase_flops=tuple(sorted(phase_flops.items())),
        phase_bytes=tuple(sorted(phase_bytes.items())),
        n_streams=n_streams, expected_streams=expected,
        forward_flops=fwd_flops, ref_forward_flops=ref_flops,
        residual_sharing=sharing,
        findings=tuple(findings), allowlisted=tuple(allowlisted),
        kernel_flops=k_flops, kernel_bytes=k_bytes,
        phase_contraction_flops=tuple(sorted(phase_cf.items())))


def check_train_step(loss_fn, params, batch, consumers, **kw):
    """Convenience: record one training step and analyze it."""
    allow = kw.pop("allow_known_streams", True)
    return analyze_trace(
        _T.trace_train_step(loss_fn, params, batch, consumers, **kw),
        allow_known_streams=allow)
