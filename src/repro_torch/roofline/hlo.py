"""Collective and cost accounting of a recorded program.

Port of ``src/repro/roofline/hlo.py``. The reference parsed compiled HLO
text: every collective's operand bytes, and XLA's ``cost_analysis`` for a
compiled executable's (flops, bytes accessed). The port compiles no
program and has no HLO; it reads the same quantities off a record of the
program (``analysis._trace``: a ``Trace`` of one step on ``meta``
tensors), keeping the function names:

  * ``collective_bytes`` / ``collective_counts`` — the operand bytes and
    the count of the all-reduces ``dist.pex`` records (one per gradient
    leaf, and the zero-filled gathers of the per-example outputs), by
    kind, the one collective the port issues;
  * ``compiled_cost`` — (flops, bytes) of the record, as
    ``analysis.traffic.program_cost`` counts them (eager: every op's
    operands and results; a kernel site at its launch contract).

A record counts every layer (the port's layers run in a Python loop), so
nothing here needs a trip count.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

#: the reference's name for the one collective kind the port records
ALL_REDUCE = "all-reduce"


def collective_bytes(trace) -> Dict[str, float]:
    """Operand bytes per collective kind over the whole record, with the
    all-reduces split by what they carry (``all-reduce/reduce``: summed
    gradient leaves; ``all-reduce/gather``: zero-filled per-example rows)
    and a ``total``."""
    out: Dict[str, float] = defaultdict(float)
    for op in trace.of_kind("collective"):
        b = float(trace.tensors[op.ins[0]].nbytes)
        out[ALL_REDUCE] += b
        out[f"{ALL_REDUCE}/{op.meta.get('kind', '?')}"] += b
    out["total"] = float(out[ALL_REDUCE])
    return dict(out)


def collective_counts(trace) -> Dict[str, int]:
    """Collectives of the record, by kind."""
    out: Dict[str, int] = defaultdict(int)
    for op in trace.of_kind("collective"):
        out[ALL_REDUCE] += 1
        out[f"{ALL_REDUCE}/{op.meta.get('kind', '?')}"] += 1
    return dict(out)


def compiled_cost(trace) -> Tuple[float, float]:
    """(flops, bytes) of a recorded program."""
    from repro_torch.analysis.traffic import program_cost
    return program_cost(trace)
