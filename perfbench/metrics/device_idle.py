"""Share of the profiled steps' span in which no operation ran on the
device: 1 − (union of the device intervals) / span, from the profiler's
trace."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "tokens_per_s"


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
