"""The program's own spans and counters in the traced run.

The traced run's profile is taken first, as the runner takes it: with the
program's recorder off, so that every existing reading (the device
operations, the busy time, the idle gaps) comes from the same steps as
before. Two phases follow it, for the metrics that read the program's
record:

- ``RECORDED_STEPS`` steps under ``repro_torch.spans.recording(device)``
  with no profiler; their ``spans.Record`` is the profile's ``record``;
- ``runner.PROFILED_STEPS`` steps under a second ``torch.profiler`` run
  and ``recording(device, timed=False)``, so that the program's spans lie
  on the profiler's clock as user annotations and no timing event is in
  that profile; it is the profile's ``marked``, a ``Marked``.

With ``--trace 0``, or for a program without the recorder, neither phase
runs, and ``record`` and ``marked`` are None.

``lib/runner.py`` calls its module's ``profiled`` after the window and has
no other hook after it; its files are the accepted benchmark's and are not
edited, so this module puts its ``profiled`` in that place when it is
first imported. Every metric that reads the record imports it, so loading
a cell that reports one of them is what turns the two phases on.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from perfbench.lib import runner, trace

RECORDED_STEPS = 3

#: the runner's own profile, taken with the recorder off
_unrecorded = runner.profiled


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


class Marked(trace.Profile):
    """A profile with the program's annotations (``marks``: name, start,
    end in microseconds, ordered by start). ``trace.Profile`` leaves them
    out of the device operations, the busy time and the host operations
    that name idle gaps."""

    def __init__(self, prof, n_steps: int):
        from torch.autograd import DeviceType
        super().__init__(prof, n_steps)
        self.marks: List[Tuple[str, float, float]] = sorted(
            ((e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if getattr(e, "is_user_annotation", False)
             and e.device_type != DeviceType.CUDA
             and e.name != trace.STEP_MARK), key=lambda m: m[1])

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals inside the steps' span (those
        ``idle_gaps`` sums)."""
        lo, hi = self.span
        edges = [lo] + [x for s, e in self.busy for x in (s, e)] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]


def profiled(prog, device) -> trace.Profile:
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = _unrecorded(prog, device)
    prof.record = prof.marked = None
    spans = recorder()
    if spans is None:
        return prof
    with spans.recording(device) as record:
        for _ in range(RECORDED_STEPS):
            prog.step()
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with spans.recording(device, timed=False), \
            profile(activities=acts) as marked:
        for _ in range(runner.PROFILED_STEPS):
            with record_function(trace.STEP_MARK):
                prog.step()
        runner.sync(device)
    prof.record = record
    prof.marked = Marked(marked, runner.PROFILED_STEPS)
    return prof


runner.profiled = profiled


def record(run):
    """The recorded steps' ``spans.Record``, or None."""
    return getattr(run.profile, "record", None)


def marked(run) -> Optional[Marked]:
    """The marked profile, or None."""
    return getattr(run.profile, "marked", None)


def per_step(run, name: str, host: bool = False) -> Optional[float]:
    """Σ of span ``name``'s device ms (host ms with ``host``, or where
    the record is untimed: on the CPU, in the tests, as ``trace.Spans``)
    over the recorded steps ÷ the number of ``trainer.step`` spans; None
    where no such span was recorded."""
    rec = record(run)
    if rec is None:
        return None
    steps = len(rec.named("trainer.step"))
    host = host or not rec.timed
    got = [s.host_ms if host else s.device_ms for s in rec.named(name)]
    if not steps or not got:
        return None
    return sum(got) / steps
