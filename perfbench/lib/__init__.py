"""The harness's shared code: the cell's files, the weights and tokens made
from the seed, the step runner, the profiler's reading and the comparison
that decides ``correct``."""
