"""Device milliseconds a step spends adding the DP-SGD noise to the
summed gradient (the program's ``plan.noise`` spans): Σ of their device
ms over the steps the traced run records after its
profile (``lib/recorded.py``) ÷ the number of ``trainer.step`` spans there."""
from perfbench.lib import recorded

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Engine / plan"
MOVES = "tokens_per_s"


def read(run):
    return recorded.per_step(run, "plan.noise")
