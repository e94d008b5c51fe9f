"""Seconds from the process's start to the window's: imports, the kernel
library loaded (built on a checkout's first run), weights made on the card
from the seed, the trainer and its optimizer state, and the checked first
steps, which compile and warm every shape the window uses."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
