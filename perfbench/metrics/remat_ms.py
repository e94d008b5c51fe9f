"""Device milliseconds a step spends re-running checkpointed blocks
inside its backward passes (the program's ``remat.recompute`` spans, each
nested in the backward's span): Σ of their device ms, every backward of
the step, over the steps the traced run records after its
profile (``lib/recorded.py``) ÷ the number of ``trainer.step`` spans there."""
from perfbench.lib import recorded

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Model"
MOVES = "tokens_per_s"


def read(run):
    return recorded.per_step(run, "remat.recompute")
