"""pexlint — static analysis over recorded steps and launch contracts
(DESIGN.md §10, §12).

Port of ``src/repro/analysis``'s trace-only passes. None of them runs a
kernel or computes a value: each records the program on ``meta`` tensors
(``_trace``, the port's counterpart of the reference's ``_jaxpr.py``: a
flat record of one ``Engine.step`` in place of a jaxpr) and walks the
record.

  * ``coverage`` — tap-coverage verification: walk the recorded loss from
    every trainable leaf toward the loss and prove each parameter is
    tapped, declared frozen, or explicitly allowlisted;
  * ``launch`` — kernel-launch validation of every CUDA launch a trace
    names (and each Tap site could dispatch to), against the declared
    ``LaunchContract``s and the H100's budgets (``kernels.contract``);
  * ``privacy`` — dataflow proof of the DP invariants over a full recorded
    step: every trained gradient scaled by the per-example clip
    coefficient before any batch sum, Gaussian noise injected exactly once
    after the gradient all-reduce at scale σ·C, generator states drawn
    once;
  * ``collectives`` — the data-parallel layout of ``dist.pex``: per-example
    outputs gathered through zero-filled buffers and never summed,
    gradients summed exactly once over the data shards;
  * ``determinism`` — AST verification that the data pipeline and the
    soak replay path are pure in (seed, step).

The cost side records a whole training step (``_trace.trace_train_step``:
the plan and the optimizer apply) on ``meta`` tensors:

  * ``traffic`` — flops and HBM bytes by phase (forward / activation-bwd /
    weight-bwd / stats / apply), gradient streams, and the redundant
    stream, duplicate forward, dead residual and upcast findings;
  * ``cost`` — a ``CostReport`` on the H100 profile
    (``roofline.constants``) and the gate against the port's committed
    ``cost_baseline.json``;
  * ``plan_invariants`` — the zero-overhead and one-forward-budget claims,
    on recorded programs.

``verify.verify`` (surfaced as ``Engine.verify``) composes them;
``python -m repro_torch.analysis`` lints every registered model
(``--cost`` for the cost side and its gate).
"""
from repro_torch.analysis.collectives import (CollectivesReport,
                                              ScheduleEntry,
                                              expected_schedule)
from repro_torch.analysis.cost import CostReport, build_cost, check_baseline
from repro_torch.analysis.coverage import (AnalysisError, CoverageReport,
                                           LeafReport, TapSite,
                                           trace_coverage)
from repro_torch.analysis.determinism import (DeterminismReport,
                                              check_source)
from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding
from repro_torch.analysis.launch import (LaunchReport, contracts_for_sites,
                                         production_cases,
                                         validate_contracts, validate_sites)
from repro_torch.analysis.privacy import PrivacyReport
from repro_torch.analysis.traffic import TrafficReport
from repro_torch.analysis.verify import VerifyReport, verify

__all__ = [
    "AnalysisError", "CoverageReport", "LeafReport", "TapSite",
    "trace_coverage", "LaunchReport", "contracts_for_sites",
    "production_cases", "validate_contracts", "validate_sites",
    "VerifyReport", "verify",
    "Finding", "ERROR", "WARNING", "INFO",
    "PrivacyReport", "CollectivesReport", "ScheduleEntry",
    "expected_schedule", "DeterminismReport", "check_source",
    "TrafficReport", "CostReport", "build_cost", "check_baseline",
]
