"""Share of the MoE layers' capacity slots that carry a token, over the
steps the traced run records after its profile (``lib/recorded.py``):
100 × ``moe.filled`` ÷ ``moe.slots``, the program's counters, added once
per forward of each MoE layer: slots = groups × experts × capacity,
filled = Σ over groups and experts of min(tokens routed, capacity). The
expert products run over every slot, so 100 − this is the share of their
rows that is padding. (The share of assignments that capacity drops is
1 − ``moe.filled`` ÷ ``moe.assignments``, tokens × top-k.)"""
from perfbench.lib import recorded

UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "Model"
MOVES = "tokens_per_s"


def read(run):
    rec = recorded.record(run)
    slots = rec.counters.get("moe.slots") if rec is not None else None
    if not slots:
        return None
    return 100.0 * rec.counters["moe.filled"] / slots
