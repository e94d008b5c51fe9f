"""Collective and cost accounting of a recorded program.

Port of ``src/repro/roofline/hlo.py``. The reference parsed compiled HLO
text: every collective's operand bytes, and XLA's ``cost_analysis`` for a
compiled executable's (flops, bytes accessed). The port compiles no
program and has no HLO; it reads the same quantities off a record of the
program (``analysis._trace``: a ``Trace`` of one step on ``meta``
tensors), keeping the function names:

  * ``collective_bytes`` / ``collective_counts`` — the operand bytes and
    the count of the collectives of the record, by kind: the all-reduces
    ``dist.pex`` records (one per gradient leaf, and the zero-filled
    gathers of the per-example outputs), and on the sharded route the
    functional collectives of DTensor's redistributions (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``), each also under
    ``kind@axes``, the mesh axes of its group;
  * ``compiled_cost`` — (flops, bytes) of the record, as
    ``analysis.traffic.program_cost`` counts them (eager: every op's
    operands and results; a kernel site at its launch contract).

A record counts every layer (the port's layers run in a Python loop), so
nothing here needs a trip count.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

#: the reference's name for the collective kind ``dist.pex`` records
ALL_REDUCE = "all-reduce"

#: the reference's (HLO) names of the functional collectives' kinds
KINDS = {"all_reduce": ALL_REDUCE, "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def _collectives(trace):
    """(keys, operand bytes) of every collective of the record: its kind
    and, ``dist.pex``'s, what it carries (``all-reduce/reduce``: summed
    gradient leaves; ``all-reduce/gather``: zero-filled per-example rows),
    a functional collective's ``kind@axes``."""
    for op in trace.ops:
        if op.kind == "collective":
            yield ((ALL_REDUCE, f"{ALL_REDUCE}/{op.meta.get('kind', '?')}"),
                   float(trace.tensors[op.ins[0]].nbytes))
        elif op.kind == "aten" and op.meta and "collective" in op.meta:
            kind = KINDS[op.meta["collective"]]
            axes = "+".join(op.meta.get("axes") or ("?",))
            yield ((kind, f"{kind}@{axes}"),
                   float(trace.tensors[op.ins[0]].nbytes))


def collective_bytes(trace) -> Dict[str, float]:
    """Operand bytes per collective kind over the whole record (module
    docstring), and a ``total``."""
    out: Dict[str, float] = defaultdict(float)
    total = 0.0
    for keys, b in _collectives(trace):
        for k in keys:
            out[k] += b
        total += b
    out["total"] = total
    return dict(out)


def collective_counts(trace) -> Dict[str, int]:
    """Collectives of the record, by kind."""
    out: Dict[str, int] = defaultdict(int)
    for keys, _ in _collectives(trace):
        for k in keys:
            out[k] += 1
    return dict(out)


def compiled_cost(trace) -> Tuple[float, float]:
    """(flops, bytes) of a recorded program."""
    from repro_torch.analysis.traffic import program_cost
    return program_cost(trace)
