"""Training tokens completed in the window over the window's wall time
(host clock from the window's start to the end of its last step, which
ends in a synchronize)."""
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
