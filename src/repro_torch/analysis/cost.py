"""pexcost — analytic step-time prediction from the traffic pass
(DESIGN.md §13).

Port of ``src/repro/analysis/cost.py``. ``analysis.traffic`` attributes
the recorded training step's flops and HBM bytes; this module divides
them by a named :class:`~repro_torch.roofline.constants.HardwareProfile`
(the H100's, ``h100-sxm-80gb``) to produce a ``CostReport`` with compute /
memory / collective time terms — a "static bench" that runs on the CPU in
seconds. The kernel launches of the step enter the traffic pass through
their launch contracts (``kernels.ops``: each launch's least ``flops`` and
``hbm_bytes()``); further ``contracts`` may be added here. Collectives
enter through the recorded all-reduces' operand bytes, scaled by the ring
all-reduce's wire volume 2·(chips−1)/chips over the profile's NVLink.

The gate: ``check_baseline`` holds a run's reports against the port's
committed baseline (``src/repro_torch/analysis/cost_baseline.json``,
written by ``python -m repro_torch.analysis --cost --write-cost-baseline``
at smoke widths over the ten archs): a plan whose predicted flops or bytes
grow beyond tolerance over the baseline is an ERROR (``cost-regression``);
shrinkage beyond tolerance and key churn are WARNINGs (re-baseline, don't
fail). The reference's ``COST_BASELINE.json`` at the repository's root is
the reference's and is not read here.

Everything is static: the numbers are predictions from a recorded step
and public peak specs, not measurements — the report names the profile so
the denominators are never implicit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.analysis.traffic import TrafficReport
from repro_torch.roofline.constants import DEFAULT_PROFILE, get_profile

PASS = "cost"

#: baseline metrics the regression gate compares (prediction keys of
#: one CostReport row; times are derived, so gating on the raw
#: flop/byte terms keeps the gate profile-independent)
BASELINE_METRICS = ("flops", "hbm_bytes", "coll_bytes")

#: the port's committed baseline
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "cost_baseline.json")


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Predicted step budget of one (model × granularity × plan) on one
    named hardware profile."""
    model: str
    granularity: str
    optimizer: str
    plan_desc: str
    profile: str                # HardwareProfile name — the denominators
    chips: int
    flops: float                # the record's flops, every layer's
    hbm_bytes: float            # eager traffic: every op's operands, results
    coll_bytes: float           # all-reduce operand bytes (per step)
    kernel_flops: float         # the kernel launches' contract work
    kernel_hbm_bytes: float     # the kernel launches' contract bytes
    t_compute: float            # seconds
    t_memory: float
    t_collective: float
    t_step: float               # max of the three — overlap model
    bottleneck: str             # 'compute' | 'memory' | 'collective'
    phase_bytes: Tuple[Tuple[str, float], ...]
    n_streams: int
    expected_streams: int

    def summary(self) -> str:
        return (f"cost[{self.model}/{self.granularity}] on {self.profile}"
                f"×{self.chips}: {self.t_step * 1e6:.1f}us "
                f"({self.bottleneck}-bound; compute "
                f"{self.t_compute * 1e6:.1f}us, memory "
                f"{self.t_memory * 1e6:.1f}us, collective "
                f"{self.t_collective * 1e6:.1f}us) — "
                f"{self.flops:.3g} flops, "
                f"{self.hbm_bytes / 1e6:.1f} MB, "
                f"streams {self.n_streams}/{self.expected_streams}")

    def to_json(self) -> dict:
        return {
            "model": self.model, "granularity": self.granularity,
            "optimizer": self.optimizer, "plan": self.plan_desc,
            "profile": self.profile, "chips": self.chips,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "kernel_flops": self.kernel_flops,
            "kernel_hbm_bytes": self.kernel_hbm_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "t_step_s": self.t_step,
            "bottleneck": self.bottleneck,
            "phase_bytes": dict(self.phase_bytes),
            "n_streams": self.n_streams,
            "expected_streams": self.expected_streams,
        }


def contract_seconds(contract, profile: str = DEFAULT_PROFILE) -> float:
    """One launch's roofline time on a profile: the larger of its work
    over the bf16 peak and its bytes over the HBM rate."""
    hw = get_profile(profile)
    return max(contract.flops / hw.peak_flops_bf16,
               contract.hbm_bytes() / hw.hbm_bw)


def build_cost(traffic: TrafficReport, *, model: str = "?",
               profile: str = DEFAULT_PROFILE, chips: int = 1,
               contracts: Sequence = ()) -> CostReport:
    """Compose one TrafficReport (+ further ``contracts``, launches beyond
    the step's own) into a CostReport on a named hardware profile.

    The time model is the roofline overlap bound: each term assumes
    perfect overlap with the others, ``t_step`` is their max. The
    collective term uses the ring all-reduce wire volume —
    ``coll_bytes · 2(chips−1)/chips`` per card over one NVLink direction —
    which is 0 on a single card.
    """
    hw = get_profile(profile)
    chips = max(int(chips), 1)
    x_flops = float(sum(getattr(c, "flops", 0.0) for c in contracts))
    x_bytes = float(sum(c.hbm_bytes() for c in contracts
                        if hasattr(c, "hbm_bytes")))

    # per-card shares: the recorded step is the whole batch; data
    # parallelism divides flops and local HBM traffic evenly
    t_compute = (traffic.flops + x_flops) / (hw.peak_flops_bf16 * chips)
    t_memory = (traffic.hbm_bytes + x_bytes) / (hw.hbm_bw * chips)
    wire = traffic.coll_bytes * 2.0 * (chips - 1) / chips
    t_collective = wire / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    bottleneck = max(terms, key=terms.get)

    return CostReport(
        model=model, granularity=traffic.granularity,
        optimizer=traffic.optimizer, plan_desc=traffic.plan_desc,
        profile=hw.name, chips=chips,
        flops=traffic.flops,
        hbm_bytes=traffic.hbm_bytes, coll_bytes=traffic.coll_bytes,
        kernel_flops=traffic.kernel_flops + x_flops,
        kernel_hbm_bytes=traffic.kernel_bytes + x_bytes,
        t_compute=t_compute, t_memory=t_memory,
        t_collective=t_collective, t_step=max(terms.values()),
        bottleneck=bottleneck,
        phase_bytes=traffic.phase_bytes,
        n_streams=traffic.n_streams,
        expected_streams=traffic.expected_streams)


# ---------------------------------------------------------------------------
# baseline gate
# ---------------------------------------------------------------------------

def baseline_key(report: CostReport) -> str:
    """One baseline row per (model × granularity × plan shape) — the
    plan description keys distinct consumer sets apart so a norms-only
    pass is never compared against the DP step's budget."""
    return f"{report.model}/{report.granularity}/{report.plan_desc}"


def baseline_payload(reports: Iterable[CostReport]) -> Dict[str, dict]:
    """The committed-baseline shape: predictions only (no times — the
    gate must not depend on the profile)."""
    out: Dict[str, dict] = {}
    for r in reports:
        out[baseline_key(r)] = {m: getattr(r, m) for m in BASELINE_METRICS}
    return dict(sorted(out.items()))


def check_baseline(reports: Sequence[CostReport],
                   baseline: Dict[str, dict], *,
                   tolerance: float = 0.25,
                   full_matrix: bool = True) -> List[Finding]:
    """Regression-gate findings: growth beyond tolerance is an ERROR,
    shrinkage beyond tolerance and key churn are WARNINGs (stale
    baseline — refresh with ``--write-cost-baseline``). Key churn is
    only judged under ``full_matrix`` — a single-arch run legitimately
    leaves every other arch's baseline rows unmatched."""
    findings: List[Finding] = []
    seen = set()
    for r in reports:
        key = baseline_key(r)
        seen.add(key)
        old = baseline.get(key)
        if old is None:
            findings.append(Finding(
                PASS, WARNING, "cost-baseline-missing",
                f"no committed baseline for {key!r}; add it with "
                f"--write-cost-baseline", model=r.model,
                granularity=r.granularity))
            continue
        for metric in BASELINE_METRICS:
            if metric not in old:
                continue
            ref = float(old[metric])
            new = float(getattr(r, metric))
            if ref <= 0.0:
                if new > 0.0:
                    findings.append(Finding(
                        PASS, ERROR, "cost-regression",
                        f"{key}: predicted {metric} grew 0 -> {new:.3g}",
                        model=r.model, granularity=r.granularity))
                continue
            rel = (new - ref) / ref
            if rel > tolerance:
                findings.append(Finding(
                    PASS, ERROR, "cost-regression",
                    f"{key}: predicted {metric} grew {ref:.3g} -> "
                    f"{new:.3g} (+{rel:.0%} > {tolerance:.0%})",
                    model=r.model, granularity=r.granularity))
            elif rel < -tolerance:
                findings.append(Finding(
                    PASS, WARNING, "cost-baseline-stale",
                    f"{key}: predicted {metric} shrank {ref:.3g} -> "
                    f"{new:.3g} ({rel:.0%}); refresh the baseline to "
                    f"lock in the win", model=r.model,
                    granularity=r.granularity))
    if full_matrix:
        for key in sorted(set(baseline) - seen):
            findings.append(Finding(
                PASS, WARNING, "cost-baseline-stale",
                f"baseline entry {key!r} matched no analyzed plan"))
    return findings
