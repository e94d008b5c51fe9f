"""What the traced run records: spans around the program's calls, taken
from the benchmark's own files, and the profiler's kernel timeline.

``Spans`` wraps a callable so that each call is timed on the device
(CUDA events recorded on the current stream before and after it; on the
CPU, in the tests, the host clock). ``Profile`` reads a
``torch.profiler`` run: every device operation's interval (kernels,
copies, sets), the span of the steps marked ``perfbench.step``, the union
of device intervals inside it (busy time), device time by operation name
and the longest idle gaps named by the innermost host operation running
when each began.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Callable, Dict, List, Tuple

import torch

STEP_MARK = "perfbench.step"


class Spans:
    """Device time of each call of the wrapped functions."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, List[Tuple]] = {}

    def wrap(self, name: str, fn: Callable) -> Callable:
        marks = self.marks.setdefault(name, [])

        def timed(*args, **kwargs):
            if self.cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
            else:
                a = time.perf_counter()
                out = fn(*args, **kwargs)
                b = time.perf_counter()
            marks.append((a, b))
            return out
        return timed

    def ms(self, name: str) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks.get(name, [])]
        return [(b - a) * 1e3 for a, b in self.marks.get(name, [])]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profile:
    """A profiler run's device timeline, in microseconds."""

    def __init__(self, prof, n_steps: int):
        from torch.autograd import DeviceType
        self.n_steps = n_steps
        self.device_ops: List[Tuple[str, float, float]] = []
        host = []
        steps = []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.name == STEP_MARK and e.device_type != DeviceType.CUDA:
                steps.append((start, end))
            elif getattr(e, "is_user_annotation", False) \
                    or e.name == STEP_MARK:
                continue        # a label's span, not an operation
            elif e.device_type == DeviceType.CUDA:
                self.device_ops.append((e.name, start, end))
            else:
                host.append((start, end, e.name))
        self.span = (min(s for s, _ in steps), max(e for _, e in steps)) \
            if steps else (0.0, 0.0)
        lo, hi = self.span
        inside = [(max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                  if e > lo and s < hi]
        self.busy = _merge(inside)
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches the regular
        expression ``pattern``, inside the steps' span."""
        rx = re.compile(pattern)
        lo, hi = self.span
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device_ops
                   if rx.search(n) and e > lo and s < hi) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        lo, hi = self.span
        for name, s, e in self.device_ops:
            if e > lo and s < hi:
                by[name] = by.get(name, 0.0) + (min(e, hi) - max(s, lo))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:200], v / 1e6] for k, v in top]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at time ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        for _, end, name in reversed(self._host[max(0, i - 4000):i]):
            if end >= t:
                return name
        return "(no host operation)"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle time inside the span, summed by what the host
        was doing when each gap began."""
        lo, hi = self.span
        edges = [lo] + [x for s, e in self.busy for x in (s, e)] + [hi]
        by: Dict[str, float] = {}
        for i in range(0, len(edges) - 1, 2):
            s, e = edges[i], edges[i + 1]
            if e - s > 0:
                name = self._host_at(s)
                by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:200], v / 1e6] for k, v in top]
