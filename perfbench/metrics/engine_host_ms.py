"""Host milliseconds of one ``Engine.step`` call (the program's
``engine.step`` spans, host clock from entry to exit): the time the host
takes to queue the step's work. Where it nears the step's device ms, the
host sets the pace. Σ of their host ms over the steps the traced run
records after its profile (``lib/recorded.py``) ÷ the number of
``trainer.step`` spans there."""
from perfbench.lib import recorded

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Engine / plan"
MOVES = "tokens_per_s"


def read(run):
    return recorded.per_step(run, "engine.step", host=True)
