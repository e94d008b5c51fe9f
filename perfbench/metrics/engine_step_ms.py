"""Mean device milliseconds of one ``Engine.step`` call (the forward and
both backward passes, the norms, the clip factors and the noise add), by
CUDA events that the traced run records around each call of the window."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Engine / plan"
MOVES = "tokens_per_s"


def read(run):
    ms = run.spans.get("engine.step")
    return sum(ms) / len(ms) if ms else None
