"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GiB: what decides whether a
job fits on the card and at what batch."""
UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
