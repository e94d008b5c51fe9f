"""Device milliseconds a step spends in the forward of ``core.plan``'s
fused region, tapped or plain (the program's ``plan.forward`` spans): Σ of
their device ms over the steps the traced run records after its
profile (``lib/recorded.py``) ÷ the number of ``trainer.step`` spans there."""
from perfbench.lib import recorded

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Engine / plan"
MOVES = "tokens_per_s"


def read(run):
    return recorded.per_step(run, "plan.forward")
