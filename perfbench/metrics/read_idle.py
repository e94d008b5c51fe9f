"""Share of the profiled steps' span in which the device idles after a
blocking read of the trainer's, from the second, marked profile that the
traced run takes after its own (``lib/recorded.py``): Σ of the idle gaps
(the span less the union of the device intervals, as ``device_idle``
reads them) that begin while the host is inside one of the program's
``trainer.read`` annotations (the loss, the finiteness check, the
synchronize, the norms' mean and maximum), over the span. At most the
marked profile's own idle share."""
import bisect

from perfbench.lib import recorded

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "tokens_per_s"

READ = "trainer.read"


def read(run):
    p = recorded.marked(run)
    if p is None:
        return None
    reads = [(s, e) for n, s, e in p.marks if n == READ]
    if not reads or not p.device_ops or p.window_s <= 0:
        return None
    starts = [s for s, _ in reads]

    def reading(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and reads[i][1] >= t
    idle = sum(e - s for s, e in p.gaps() if reading(s))
    return 100.0 * idle / (p.span[1] - p.span[0])
