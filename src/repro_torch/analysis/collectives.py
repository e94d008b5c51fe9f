"""Collective-layout verification of data-parallel step traces (pexlint
pass, DESIGN.md §12).

Port of ``src/repro/analysis/collectives.py``, over the port's mesh path
(``dist.pex``) instead of ``shard_map`` regions. The layout contract of
``dist.pex`` is what makes the accumulator technique free on a mesh:
per-example quantities — the (B,) loss vector, the (B, G) / (B, S) norms,
the weights and clip coefficients — come back to every rank through
zero-filled global buffers, each rank's rows written at its own offset and
the buffer all-reduced (adding zeros is exact), and are NEVER summed over
examples; the summed gradient crosses ranks in EXACTLY one
``all_reduce(SUM)`` per leaf (zero ⇒ each rank trains on its local
gradient and the replicas drift; two ⇒ the gradient is scaled by the
shard count); DP noise is added once, after that reduce.

Under a trace ``dist.pex`` records each of its all-reduces at its own call
site (``core.provenance.collective_site``) instead of sending it. This
pass walks the trace (``analysis._trace.trace_step`` with a ``mesh``) and
tells the two kinds apart by structure: a *gather* all-reduces a buffer
that a zero-fill made, whose leading extent is a multiple of the shard
count; any other all-reduce is a *sum*. Then:

  * every per-example output carries no sum in its lineage
    (``per-example-psum``);
  * every gradient leaf carries exactly one sum (``replicated-unreduced``,
    ``double-psum``) over ``count`` shards, the product of the data axes
    (``partial-psum``);
  * no noise reaches an all-reduce's input (``noise-before-psum``);
  * a trace of the mesh path holds all-reduces at all
    (``missing-region``).

``expected_schedule`` states the same contract as data, with the
reference's 2-D DP×TP form (model axes of extent > 1, which ``dist.pex``
refuses). The model-axis route (DTensor parameters, ``core.plan``'s
sharded route) records DTensor's functional collectives with their mesh
axes; :func:`analyze_sharded` holds such a step to the schedule's
model-axis entries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis import _trace as _T
from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.core import plan as plan_mod

PASS = "collectives"
_EMPTY = _T.EMPTY

#: aten ops whose output is a zero-filled buffer
ZERO_FILLS = frozenset({"aten.new_zeros.default", "aten.zeros.default",
                        "aten.zeros_like.default"})


# ---------------------------------------------------------------------------
# the declared contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleEntry:
    """One output of the fused region and the collectives it is owed."""
    output: str
    per_example: bool               # stays per-example over the data axes
    psum_axes: Tuple[str, ...]      # () = must never be summed


def _mesh_extents(mesh) -> Dict[str, int]:
    """{axis: extent} of a ``DeviceMesh`` (or of an object with
    ``axis_names`` and a ``shape`` mapping)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def expected_schedule(plan: plan_mod.Plan, mesh,
                      data_axes: Sequence[str]) -> Tuple[ScheduleEntry, ...]:
    """The collective schedule a plan's fused region owes on ``mesh``.

    With every non-data axis at extent 1 this is the executable contract:
    per-example outputs never summed, gradients summed once over the data
    axes. With a model axis (DP×TP) the per-example entries gain a
    model-axis sum — each tensor shard holds only its slice of every
    example's norm and loss — and the gradient sums over both."""
    data = tuple(data_axes)
    model = tuple(a for a, n in _mesh_extents(mesh).items()
                  if a not in data and n > 1)
    entries: List[ScheduleEntry] = [
        ScheduleEntry("loss_vec", True, model)]
    if plan.needs_norms:
        entries.append(ScheduleEntry("sq_norms", True, model))
    if plan.weighted or plan.token_weighted:
        # weights are functions of already-complete norms: no collective
        entries.append(ScheduleEntry("weights", True, ()))
    if plan.needs_grads:
        entries.append(ScheduleEntry("grads", False, data + model))
    return tuple(entries)


# ---------------------------------------------------------------------------
# report datatypes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReduceSite:
    index: int
    kind: str                       # "gather" | "sum" (by structure)
    declared: str                   # the kind dist.pex named
    count: int                      # shards it sums over
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class OutputLayout:
    field: str
    leaf: str
    per_example: bool
    sums: int                       # distinct sum all-reduces in lineage


@dataclasses.dataclass(frozen=True)
class CollectivesReport:
    reduces: Tuple[ReduceSite, ...]
    outputs: Tuple[OutputLayout, ...]
    schedule: Tuple[ScheduleEntry, ...]
    findings: Tuple[Finding, ...]

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        n_g = sum(r.kind == "gather" for r in self.reduces)
        n_pe = sum(o.per_example for o in self.outputs)
        head = (f"collectives: {len(self.reduces)} all-reduce(s) "
                f"({n_g} gathers, {len(self.reduces) - n_g} sums); "
                f"{n_pe} per-example + {len(self.outputs) - n_pe} "
                f"replicated outputs")
        return "\n".join([head] + [f"  {f.render()}" for f in self.findings])


# ---------------------------------------------------------------------------
# the walker — all-reduce lineage
# ---------------------------------------------------------------------------

class _ReduceWalker(_T.Walker):
    def __init__(self):
        self.sites: Dict[str, ReduceSite] = {}
        self.zero_filled: set = set()
        self.noise_in_reduce = False

    def hook(self, op, in_t):
        if op.kind == "aten" and op.name in ZERO_FILLS:
            self.zero_filled.update(op.outs)
            return None
        if op.kind == "mark" and op.name == "noise":
            for tid in op.outs:
                self.replace(tid, frozenset({f"noise:{op.index}"}))
            return []
        if op.kind != "collective":
            return None
        (tid,) = op.ins
        count = op.meta["count"]
        shape = op.meta["shape"]
        gather = (tid in self.zero_filled and bool(shape)
                  and shape[0] % count == 0)
        tok = f"ar:{op.index}"
        self.sites[tok] = ReduceSite(len(self.sites),
                                     "gather" if gather else "sum",
                                     op.meta["kind"], count, shape)
        if any(t.startswith("noise:") for t in in_t[0]):
            self.noise_in_reduce = True
        return [in_t[0] | {tok}]


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def analyze_trace(trace: _T.StepTrace) -> CollectivesReport:
    """Check the collective layout of one ``StepTrace``. A trace of the
    local path has no all-reduces and passes trivially (it has no
    collectives to get wrong)."""
    findings: List[Finding] = []
    walker = _ReduceWalker()
    walker.run(trace, {})
    sites = walker.sites
    schedule: Tuple[ScheduleEntry, ...] = ()
    if trace.meshed:
        schedule = expected_schedule(trace.plan, trace.mesh,
                                     trace.data_axes)
        if not sites:
            findings.append(Finding(
                PASS, ERROR, "missing-region",
                "the step was traced through the mesh path but holds no "
                "all-reduce: the fused core is not actually sharded"))
    want = None
    if trace.meshed:
        ext = _mesh_extents(trace.mesh)
        want = math.prod(ext[a] for a in trace.data_axes)

    outputs = []
    for field, leaf, tid in trace.outputs:
        if field == "gns":
            continue
        taint = walker.taint(tid)
        sums = [sites[t] for t in taint
                if t in sites and sites[t].kind == "sum"]
        per_example = field in _T.PER_EXAMPLE_FIELDS
        outputs.append(OutputLayout(field, leaf, per_example, len(sums)))
        if not trace.meshed:
            continue
        where = f"{field}" + (f" {leaf}" if leaf else "")
        if per_example:
            if sums:
                findings.append(Finding(
                    PASS, ERROR, "per-example-psum",
                    f"output {where} is a per-example quantity but its "
                    f"lineage contains a sum over the data shards of a "
                    f"{sums[0].shape} tensor that is not a zero-filled "
                    f"gather buffer: per-example statistics must never be "
                    f"reduced over the data axes",
                    leaf=leaf or None))
        elif not sums:
            findings.append(Finding(
                PASS, ERROR, "replicated-unreduced",
                f"output {where} is replicated but no all-reduce(SUM) "
                f"appears in its lineage: each rank would return its local "
                f"gradient, and the replicas drift", leaf=leaf or None))
        elif len(sums) > 1:
            findings.append(Finding(
                PASS, ERROR, "double-psum",
                f"output {where} crosses {len(sums)} distinct sums: the "
                f"gradient is scaled by the shard count once per extra "
                f"reduction", leaf=leaf or None))
        elif sums[0].count != want:
            findings.append(Finding(
                PASS, ERROR, "partial-psum",
                f"output {where} is summed over {sums[0].count} shards but "
                f"the data axes {trace.data_axes} hold {want}",
                leaf=leaf or None))
    if walker.noise_in_reduce:
        findings.append(Finding(
            PASS, ERROR, "noise-before-psum",
            "noise reaches the input of an all-reduce: it is added per "
            "rank before the gradient sum, not once after it"))
    return CollectivesReport(tuple(sorted(sites.values(),
                                          key=lambda s: s.index)),
                             tuple(outputs), schedule, tuple(findings))


def check_step(loss_fn, params, batch, consumers, **trace_kw):
    """Convenience: trace ``Engine.step`` and analyze its collectives."""
    return analyze_trace(_T.trace_step(loss_fn, params, batch, consumers,
                                       **trace_kw))


# ---------------------------------------------------------------------------
# the sharded route: DTensor's functional collectives
# ---------------------------------------------------------------------------

class _FunctionalWalker(_T.Walker):
    """Lineage of the functional collectives a DTensor step records: each
    adds a token ``kind@axes:index`` to its output's taint."""

    def __init__(self):
        self.noise_in_collective = False

    def hook(self, op, in_t):
        if op.kind == "mark" and op.name == "noise":
            for tid in op.outs:
                self.replace(tid, frozenset({f"noise:{op.index}"}))
            return []
        if op.kind != "aten" or not op.meta or "collective" not in op.meta:
            return None
        if any(t.startswith("noise:") for ts in in_t for t in ts):
            self.noise_in_collective = True
        axes = "+".join(op.meta.get("axes") or ("?",))
        tok = f"{op.meta['collective']}@{axes}:{op.index}"
        merged = frozenset().union(*in_t) if in_t else _EMPTY
        return [merged | {tok} for _ in op.outs]


def analyze_sharded(trace, outputs, plan, mesh_extents: Dict[str, int],
                    data_axes: Sequence[str] = ("data",)
                    ) -> Tuple[Finding, ...]:
    """Hold one recorded sharded step (``Engine`` on DTensor parameters;
    ``outputs`` the ``(field, leaf, tensor id)`` of its results) to
    ``expected_schedule``'s model-axis entries: every per-example output
    it owes a sum over a model axis carries an ``all_reduce`` or a
    ``reduce_scatter`` over that axis in its lineage
    (``missing-model-sum``); every gradient leaf, where the data axes
    have extent > 1, carries a collective over each of them
    (``grad-unreduced``): the other ranks' rows reach it, summed into it
    or gathered before it (a leaf computed from a gathered cotangent
    needs no sum after); no noise reaches a
    collective's input (``noise-before-psum``). The gradient's model-axis
    entry does not apply: a leaf sharded over the model axis is each
    rank's own block, and a replicated one is computed whole on every
    rank."""
    class _Mesh:
        axis_names = tuple(mesh_extents)
        shape = dict(mesh_extents)
    schedule = {e.output: e for e in expected_schedule(plan, _Mesh(),
                                                       data_axes)}
    walker = _FunctionalWalker()
    walker.run(trace, {})
    findings: List[Finding] = []
    data = [a for a in data_axes if mesh_extents.get(a, 1) > 1]

    def reduced_over(taint, axis, kinds=("all_reduce", "reduce_scatter")):
        for t in taint:
            kind, _, axes = t.split(":")[0].partition("@")
            if kind in kinds and axis in axes.split("+"):
                return True
        return False
    for field, leaf, tid in outputs:
        entry = schedule.get(field)
        taint = walker.taint(tid)
        if field in ("loss_vec", "sq_norms") and entry is not None:
            for axis in entry.psum_axes:
                if not reduced_over(taint, axis):
                    findings.append(Finding(
                        PASS, ERROR, "missing-model-sum",
                        f"output {field} is owed a sum over the model axis "
                        f"{axis!r} (each shard holds a slice of every "
                        f"example's value), and its lineage holds none"))
        if field == "grads":
            for axis in data:
                if not reduced_over(taint, axis, ("all_reduce",
                                                  "reduce_scatter",
                                                  "all_gather")):
                    findings.append(Finding(
                        PASS, ERROR, "grad-unreduced",
                        f"gradient {leaf} crosses no collective over the "
                        f"data axis {axis!r}: each rank would keep its own "
                        f"rows' gradient", leaf=leaf))
    if walker.noise_in_collective:
        findings.append(Finding(
            PASS, ERROR, "noise-before-psum",
            "noise reaches the input of a collective: it is added per rank "
            "before the gradient sum, not once after it"))
    return tuple(findings)
