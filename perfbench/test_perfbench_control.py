"""The comparison that decides ``correct`` fails what it must, on the CPU
at a small float32 size: the control (the reference computed with FP8
products, put in the program's place) and each fault a one-chip training
cell can have, planted in the program underneath the timed path, while
the harness's look for a chip is skipped and the rest of a run is driven.
On the chip ``perfbench/control.py`` reads the same at each cell's own
size."""
from __future__ import annotations

import time

import pytest

from perfbench.lib import check, faults, runner, spec
from perfbench.reference import lowp


@pytest.mark.parametrize("cell", ["small-dense.dpsgd", "small-moe.dpsgd",
                                  "small-dense.plain"])
def test_the_control_is_not_correct(small_root, cell):
    c = spec.load_cell(cell, small_root)
    steps = c.traffic["check_steps"]
    ref = runner.reference(c, 5, "cpu", steps)
    ctl = runner.reference(c, 5, "cpu", steps, mm=lowp.fp8_mm)
    correct, checks = check.decide(
        check.numbers(ctl, ref, runner.wants_norms(c),
                      runner.wants_noise(c)), c.limits)
    assert not correct, checks


@pytest.mark.parametrize("fault", sorted({**faults.REFERENCE,
                                          **faults.REFERENCE_CLIP}))
def test_a_fault_planted_in_the_reference_is_not_correct(small_root, fault):
    """The faults ``perfbench/control.py`` plants in the reference put in
    the program's place, for the upper readings on the chip."""
    c = spec.load_cell("small-dense.dpsgd", small_root)
    steps = c.traffic["check_steps"]
    ref = runner.reference(c, 5, "cpu", steps)
    kwargs = {**faults.REFERENCE, **faults.REFERENCE_CLIP}[fault]
    bad = runner.reference(c, 5, "cpu", steps, **kwargs)
    correct, checks = check.decide(
        check.numbers(bad, ref, True, True), c.limits)
    assert not correct, checks


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ("small-dense.dpsgd", "small-dense.plain")
    for fault in sorted(faults.PROGRAM)] + [
    ("small-dense.dpsgd", fault) for fault in sorted(faults.PROGRAM_CLIP)])
def test_a_run_with_a_fault_is_not_correct(small_root, cell, fault):
    c = spec.load_cell(cell, small_root)
    plant = {**faults.PROGRAM, **faults.PROGRAM_CLIP}[fault]
    with plant():
        res = runner.run(c, 2**31 + 3, 0.05, False, "cpu",
                         time.perf_counter())
    assert not res["correct"], res["checks"]
