"""Mean device milliseconds of one ``adamw.update`` call, by CUDA events
that the traced run records around each call of the window."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Step"
MOVES = "tokens_per_s"


def read(run):
    ms = run.spans.get("adamw.update")
    return sum(ms) / len(ms) if ms else None
