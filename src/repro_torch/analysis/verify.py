"""``Engine.verify`` backend — one call that runs every trace-only pexlint
pass against a model (DESIGN.md §10, §12).

Port of ``src/repro/analysis/verify.py``. Composes the analyzers:

  * plan analysis (``core.plan.analyze``) validates the consumer list and
    yields the static cost shape (``Plan.describe()``);
  * tap coverage (``analysis.coverage``) proves every trained parameter's
    gradient is reachable by a tap, modulo the declared allowlist;
  * launch validation (``analysis.launch``) checks every CUDA launch the
    traces name — each recorded kernel site, the launches each Tap site
    could dispatch to, and the config-derived production geometries —
    against the H100's budgets;
  * privacy flow (``analysis.privacy``) walks a full recorded step per
    consumer set and proves the DP dataflow invariants — clip-before-sum,
    noise-once-after-the-reduce, σ·C scale, single-use generator states;
  * collective layout (``analysis.collectives``) checks a mesh trace's
    all-reduces against the per-example / replicated contract;
  * determinism (``analysis.determinism``) statically verifies the data
    pipeline and soak replay path are (seed, step)-pure;
  * with ``cost``, traffic (``analysis.traffic``) over a recorded training
    step — the plan and the optimizer apply — and its cost
    (``analysis.cost``) on a hardware profile.

Everything here records on ``meta`` tensors — no kernel runs, nothing is
computed, no collective is sent — so it takes parameters and batches on
any device and is cheap enough to run on every registered model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.analysis import _trace as _T
from repro_torch.analysis import collectives as _col
from repro_torch.analysis import cost as _cost
from repro_torch.analysis import coverage as _cov
from repro_torch.analysis import determinism as _det
from repro_torch.analysis import launch as _launch
from repro_torch.analysis import privacy as _priv
from repro_torch.analysis import traffic as _traf
from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.core import plan as plan_mod
from repro_torch.core.taps import ExampleLayout, PexSpec, TokenLayout


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Combined result of one ``Engine.verify`` run. ``traces`` holds the
    step trace of each consumer set that ``deep`` recorded (its kernel
    sites are what the card would launch for that step)."""
    plans: Tuple[plan_mod.Plan, ...]
    coverage: _cov.CoverageReport
    launch: _launch.LaunchReport
    privacy: Tuple[_priv.PrivacyReport, ...] = ()
    collectives: Tuple[_col.CollectivesReport, ...] = ()
    determinism: Optional[_det.DeterminismReport] = None
    traces: Tuple[_T.StepTrace, ...] = ()
    traffic: Tuple[_traf.TrafficReport, ...] = ()
    cost: Tuple[_cost.CostReport, ...] = ()

    @property
    def findings(self) -> Tuple[Finding, ...]:
        """Every Finding from the flow passes (privacy, collectives,
        determinism, traffic); coverage/launch keep their own report
        shapes, and allowlisted traffic findings stay on the
        TrafficReport."""
        out: Tuple[Finding, ...] = ()
        for r in self.privacy + self.collectives:
            out += r.findings
        if self.determinism is not None:
            out += self.determinism.findings
        for t in self.traffic:
            out += t.findings
        return out

    @property
    def ok(self) -> bool:
        return (self.coverage.ok and self.launch.ok
                and all(r.ok for r in self.privacy)
                and all(r.ok for r in self.collectives)
                and all(t.ok for t in self.traffic)
                and (self.determinism is None or self.determinism.ok))

    @property
    def errors(self) -> Tuple[str, ...]:
        cov = tuple(f"coverage: {l.path} is {l.status}"
                    for l in self.coverage.errors)
        flow = tuple(f.render() for f in self.findings
                     if f.severity == ERROR)
        return cov + tuple(f"launch: {e}" for e in self.launch.errors) \
            + flow

    def summary(self) -> str:
        lines = [f"plan[{i}]: {p.describe()}"
                 for i, p in enumerate(self.plans)]
        lines.append(self.coverage.summary())
        lines.append(self.launch.summary())
        for r in self.privacy:
            lines.append(r.summary())
        for r in self.collectives:
            lines.append(r.summary())
        if self.determinism is not None:
            lines.append(self.determinism.summary())
        for t in self.traffic:
            lines.append(t.summary())
        for c in self.cost:
            lines.append(c.summary())
        return "\n".join(lines)

    def raise_if_errors(self) -> "VerifyReport":
        self.coverage.raise_if_errors()
        self.launch.raise_if_errors()
        flow = [f.render() for f in self.findings
                if f.severity == ERROR]
        if flow:
            raise _cov.AnalysisError("\n".join(flow))
        return self


def verify(loss_fn, params, batch, consumers: Sequence = (), *,
           spec: Optional[PexSpec] = None, granularity: str = "example",
           allow: Sequence[str] = (), batch_size: Optional[int] = None,
           seq: Optional[int] = None, cfg=None, backend: str = "cuda",
           production: bool = True, mesh=None,
           data_axes: Sequence[str] = ("data",),
           deep: bool = True, determinism: bool = True,
           cost: bool = False, optimizer: str = "adamw",
           profile: Optional[str] = None, chips: int = 1,
           model: Optional[str] = None) -> VerifyReport:
    """Run all trace-only static checks for one model.

    ``consumers`` may be one consumer list or a sequence of lists — each
    is folded through plan analysis (raising on invalid compositions)
    without affecting the coverage trace; the tap sites a model emits do
    not depend on who consumes the stats. With ``deep`` (default), each
    non-empty consumer set is additionally recorded as a full
    ``Engine.step`` and run through the privacy-flow pass — against
    ``mesh`` when one is given (which also runs the collective-layout pass
    on its all-reduces) — its kernel sites join the launch validation, and
    the data pipeline's determinism contract is checked once. ``backend``
    names the launch budgets: the card's (``"cuda"``), the one the port
    has.

    With ``cost`` (independent of ``deep``), each non-empty consumer set
    is recorded as a full *training* step — plan execution plus the
    ``optimizer`` apply — and run through the traffic pass; each
    TrafficReport is composed into a ``CostReport`` on the named hardware
    ``profile`` (default ``h100-sxm-80gb``) for ``chips`` cards, named
    ``model``. Traffic findings gate ``.ok`` like every flow pass;
    allowlisted ones (the eager apply's known streams) do not."""
    _launch._check_backend(backend)
    spec = spec if spec is not None else PexSpec(enabled=True)
    if consumers and not isinstance(consumers[0], (list, tuple)):
        consumer_sets = [list(consumers)]
    else:
        consumer_sets = [list(c) for c in consumers] or [[]]
    plans = tuple(plan_mod.analyze(c, engine_granularity=granularity)
                  for c in consumer_sets)

    if granularity == "token":
        from repro_torch.core.engine import infer_seq_len
        layout = TokenLayout(seq if seq is not None
                             else infer_seq_len(batch))
    else:
        layout = ExampleLayout(spec.n_groups)
    cov = _cov.trace_coverage(loss_fn, params, batch, spec=spec,
                              layout=layout, batch_size=batch_size,
                              allow=allow)

    privacy: Tuple[_priv.PrivacyReport, ...] = ()
    collectives: Tuple[_col.CollectivesReport, ...] = ()
    traces: Tuple[_T.StepTrace, ...] = ()
    det = None
    if deep:
        for cs in consumer_sets:
            if not cs:
                continue
            tr = _T.trace_step(loss_fn, params, batch, cs, spec=spec,
                               granularity=granularity, mesh=mesh,
                               data_axes=data_axes,
                               batch_size=batch_size, seq=seq)
            traces += (tr,)
            privacy += (_priv.analyze_trace(tr),)
            if mesh is not None:
                collectives += (_col.analyze_trace(tr),)
        if determinism:
            # the data-pipeline purity contract is model-independent;
            # batch callers (the CLI) check it once and pass False here
            det = _det.analyze()

    sites = list(cov.sites)
    for tr in traces:
        sites += tr.of_kind("kernel")
    lr = _launch.validate_sites(sites, cfg, backend=backend,
                                production=production)

    traffic: Tuple[_traf.TrafficReport, ...] = ()
    cost_reps: Tuple[_cost.CostReport, ...] = ()
    if cost:
        for cs in consumer_sets:
            if not cs:
                continue
            tt = _T.trace_train_step(
                loss_fn, params, batch, cs, optimizer=optimizer,
                spec=spec, granularity=granularity, mesh=mesh,
                data_axes=data_axes, batch_size=batch_size, seq=seq)
            tr = _traf.analyze_trace(tt)
            traffic += (tr,)
            cost_reps += (_cost.build_cost(
                tr, model=model if model is not None else "model",
                profile=profile if profile is not None
                else _cost.DEFAULT_PROFILE, chips=chips),)
    return VerifyReport(plans, cov, lr, privacy, collectives, det, traces,
                        traffic, cost_reps)
