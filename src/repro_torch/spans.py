"""The port's span recorder: named spans at the training step's layer
boundaries and a few counters, kept in memory while a ``recording`` is
open, off otherwise.

    with spans.recording(device) as rec:
        trainer.run_step(batch)
    rec.spans        # [Span, ...] in the order they opened
    rec.counters     # {"moe.slots": ..., "moe.filled": ..., ...}

Off (the default), ``span(name)`` returns one shared no-op context after
one check of the module's ``_ACTIVE``: it makes no CUDA event, calls no
``record_function`` and allocates nothing; ``count`` returns at once.

On, each span records its name, an id, its parent (the span open around
it when it opened), the step of the enclosing ``trainer.step`` span and
the host clock (``time.perf_counter_ns``) at entry and exit, and enters
``torch.profiler.record_function(name)``, so that under a profiler the
span lies on the same clock as the device's operations. With ``timed``
on a CUDA device it also records a timing event on the current stream at
entry and exit; the device milliseconds are read once, after one
synchronize, when the recording closes. Each span also keeps the kernel
wrappers' launches (``kernels.ops.launch_counts``) made while it was
open. A counter adds Python numbers or 0-d device tensors; device tensors
add up on the device and are read when the recording closes, so counting
never synchronizes.

The spans (a metric of ``perfbench/metrics`` reads each one):

- ``trainer.step``: ``Trainer.run_step``, whole; it gives its step to the
  spans inside it;
- ``trainer.read``: each blocking device-to-host read in ``run_step``;
- ``engine.step``: ``Engine.step``;
- ``plan.forward``, ``plan.backward.norms``, ``plan.backward.grads``: the
  forward and the two backward passes of ``core.plan``'s fused region;
- ``plan.noise``: the noise add of ``core.plan.execute``;
- ``remat.recompute``: each re-run of a checkpointed block inside a
  backward (``core.taps``);
- ``adamw.update``: ``optim.adamw.update``.

The counters, from ``nn.moe`` once per forward of each MoE layer (never in
a recompute): ``moe.slots`` (groups × experts × capacity), ``moe.filled``
(Σ min(tokens routed, capacity) over groups and experts) and
``moe.assignments`` (tokens × top-k).

The state is one module-level record: a backward runs a recompute on the
autograd engine's thread while the thread that opened the backward's span
waits in it, so a span's parent is the last span opened in the process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    #: device milliseconds between the entry and exit events (timed
    #: recordings on a CUDA device), else None
    device_ms: Optional[float] = None
    #: kernel launches made while the span was open, by wrapper
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6


@dataclasses.dataclass
class Record:
    """What one ``recording`` kept: its spans in the order they opened and
    its counters."""
    timed: bool
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)
    _open: List[Span] = dataclasses.field(default_factory=list)
    _events: Dict[int, list] = dataclasses.field(default_factory=dict)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


#: the open recording, or None (the recorder is off)
_ACTIVE: Optional[Record] = None

_OFF = contextlib.nullcontext()


def active() -> bool:
    """Is a recording open?"""
    return _ACTIVE is not None


def span(name: str, *, step: Optional[int] = None):
    """A context manager: a span named ``name`` while a recording is open,
    the shared no-op context otherwise. ``step`` (the trainer's) passes to
    the spans opened inside it."""
    if _ACTIVE is None:
        return _OFF
    return _recorded(_ACTIVE, name, step)


def count(name: str, value) -> None:
    """Add ``value`` (a number or a 0-d tensor) to counter ``name`` while a
    recording is open."""
    rec = _ACTIVE
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + value


@contextlib.contextmanager
def _recorded(rec: Record, name: str, step: Optional[int]):
    # imported here: kernels.ops imports core, whose modules import this one
    from repro_torch.kernels import ops
    parent = rec._open[-1] if rec._open else None
    if step is None and parent is not None:
        step = parent.step
    s = Span(name, len(rec.spans), None if parent is None else parent.id,
             step, time.perf_counter_ns())
    rec.spans.append(s)
    rec._open.append(s)
    before = ops.launch_counts()
    with torch.profiler.record_function(name):
        if rec.timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        try:
            yield s
        finally:
            if rec.timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec._events[s.id] = [start, end]
            s.host_end_ns = time.perf_counter_ns()
            s.launches = {k: n - before[k]
                          for k, n in ops.launch_counts().items()
                          if n != before[k]}
            rec._open.pop()


@contextlib.contextmanager
def recording(device, *, timed: bool = True):
    """Turn the recorder on and yield its ``Record``; off again on exit,
    whatever ends the block. ``timed`` times each span on a CUDA
    ``device`` by events. Recordings do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a span recording is already open; recordings "
                           "do not nest")
    device = torch.device(device)
    rec = Record(timed=timed and device.type == "cuda")
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
    if rec.timed:
        torch.cuda.synchronize(device)
        for s in rec.spans:
            a, b = rec._events.pop(s.id)
            s.device_ms = a.elapsed_time(b)
    rec.counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                    for k, v in rec.counters.items()}
