"""CPU tests of the metrics that read the program's spans and counters
(``lib/recorded.py``): a traced run of each small cell reads them, the
window and the profile that the existing readings read come from steps
run with the recorder off, a program without the recorder runs as before,
and ``read_idle`` and the marked profile's marks by hand on a made-up
timeline."""
from __future__ import annotations

import json
import time
import types

import pytest

from perfbench.lib import recorded, runner, spec, trace

SMALL = ("small-dense.dpsgd", "small-moe.dpsgd", "small-dense.plain")

#: the new metrics, and the small cells in which each reads something
NEW = {"forward_ms": SMALL, "grads_backward_ms": SMALL,
       "remat_ms": SMALL, "engine_host_ms": SMALL,
       "norms_backward_ms": SMALL[:2], "noise_ms": SMALL[:2],
       "moe_slot_fill": SMALL[1:2], "read_idle": ()}


def _with_small_cells(root):
    """The benchmark at ``root`` with the small cells added to every
    per-layer metric's list of cells."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(SMALL)
    path.write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("cell", SMALL)
def test_a_traced_run_reads_the_programs_spans(small_root, monkeypatch,
                                               cell):
    """A traced run on the CPU: each new metric that applies to the cell
    reads a positive number, the others (``read_idle``: no device) read
    None; the window's steps, the outside wrappers' spans and the profile
    that the existing metrics read ran with the recorder off, the recorded
    and the marked profile's steps after them with it on."""
    from repro_torch import spans
    c = spec.load_cell(cell, _with_small_cells(small_root))
    assert runner.profiled is recorded.profiled
    seen = []
    step = runner.Program.step

    def noting(self):
        seen.append(spans.active())
        return step(self)
    monkeypatch.setattr(runner.Program, "step", noting)
    res = runner.run(c, 2**31 + 77, 0.05, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    run, n = res["run"], res["attempted"]
    checked = c.traffic["check_steps"]
    assert seen == [False] * (checked + n + runner.PROFILED_STEPS) + [
        True] * (recorded.RECORDED_STEPS + runner.PROFILED_STEPS)
    assert len(run.spans["engine.step"]) == n == run.steps
    assert len(run.spans["adamw.update"]) == n
    rec = run.profile.record
    assert len(rec.named("trainer.step")) == recorded.RECORDED_STEPS
    got = {m.name: m.read(run) for m in c.per_layer}
    for name, cells in NEW.items():
        if cell in cells:
            assert got[name] > 0, name
        else:
            assert got.get(name) is None, name
    if cell in NEW["moe_slot_fill"]:
        # capacity 1.25 × the even share, rounded up to 8 slots
        assert got["moe_slot_fill"] <= 100 / 1.25 + 1
    assert type(run.profile) is trace.Profile
    assert run.profile.n_steps == runner.PROFILED_STEPS
    marks = {name for name, _, _ in run.profile.marked.marks}
    assert {"trainer.step", "engine.step", "trainer.read"} <= marks
    assert trace.STEP_MARK not in marks


def test_a_program_without_the_recorder_runs_as_before(small_root,
                                                       monkeypatch):
    """Where the program has no recorder (the parent of the commit that
    added it), the traced run takes its profile alone: the new metrics
    read None and the existing ones read as before."""
    c = spec.load_cell("small-moe.dpsgd", _with_small_cells(small_root))
    monkeypatch.setattr(recorded, "recorder", lambda: None)
    res = runner.run(c, 2**31 + 78, 0.05, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    run = res["run"]
    assert run.profile.record is None and run.profile.marked is None
    got = {m.name: m.read(run) for m in c.per_layer}
    assert all(got[name] is None for name in NEW)
    assert got["engine_step_ms"] > 0 and got["step_mfu"] > 0


def _ev(name, start, end, cuda=False, note=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=note)


def test_read_idle_and_marks_by_hand():
    """Two profiled steps over [0, 100] µs; the device runs [0, 30],
    [40, 70] and [75, 95]: idle 10 + 5 + 5 = 20 µs. Gaps begin at 30
    (the host inside the read [25, 38]), at 70 (no read) and at 95 (the
    read [90, 100]): 10 + 5 µs follow reads, 15%."""
    prof = types.SimpleNamespace(events=lambda: [
        _ev(trace.STEP_MARK, 0, 50, note=True),
        _ev(trace.STEP_MARK, 50, 100, note=True),
        _ev(trace.STEP_MARK, 0, 50, cuda=True, note=True),
        _ev("trainer.step", 1, 49, note=True),
        _ev("trainer.read", 25, 38, note=True),
        _ev("trainer.read", 90, 100, note=True),
        _ev("trainer.read", 26, 37, cuda=True, note=True),
        _ev("engine.step", 2, 24, note=True),
        _ev("aten::mm", 2, 3),
        _ev("cudaStreamSynchronize", 26, 37),
        _ev("gemm", 0, 30, cuda=True),
        _ev("gemm", 40, 70, cuda=True),
        _ev("copy", 75, 95, cuda=True),
    ])
    p = recorded.Marked(prof, 2)
    assert p.marks == [("trainer.step", 1, 49), ("engine.step", 2, 24),
                       ("trainer.read", 25, 38), ("trainer.read", 90, 100)]
    assert [n for n, _, _ in p.device_ops] == ["gemm", "gemm", "copy"]
    assert p.gaps() == [(30, 40), (70, 75), (95, 100)]
    assert p.idle_gaps()[0] == ["cudaStreamSynchronize", 10e-6]
    run = types.SimpleNamespace(profile=p)
    marked = types.SimpleNamespace(profile=types.SimpleNamespace(marked=p))
    idle = spec.load_metric(spec.ROOT, {
        "name": "read_idle", "unit": "%", "better": "lower",
        "source": "device_trace"}).module
    device = spec.load_metric(spec.ROOT, {
        "name": "device_idle", "unit": "%", "better": "lower",
        "source": "device_trace"}).module
    assert idle.read(marked) == pytest.approx(15.0)
    assert device.read(run) == pytest.approx(20.0)
    p.marks = [m for m in p.marks if m[0] != "trainer.read"]
    assert idle.read(marked) is None
    assert idle.read(run) is None
