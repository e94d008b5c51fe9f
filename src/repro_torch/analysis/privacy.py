"""Privacy-flow verification of a recorded DP step (pexlint pass,
DESIGN.md §12).

Port of ``src/repro/analysis/privacy.py``: the same invariants and finding
codes, over the port's trace (``analysis._trace.trace_step``) instead of a
jaxpr. The DP-SGD guarantees of the plan layer are *program* properties:
every trained leaf's gradient must be scaled by the per-example clip
coefficient before any batch sum, Gaussian noise must enter exactly once —
after the gradient all-reduce — at stddev σ·C, and no generator state may
be drawn twice. The pass anchors on the ``core.provenance`` markers
production code plants on every privacy-critical value:

**Lineage lattice.** A forward taint walk labels every tensor with the
subset of {``seed:plain``, ``seed:norms``, ``seed:weighted``, ``clip``,
``noise:<site>``, ``key``} it derives from. A ``clip_coef`` marker
*replaces* its tensor's taint with {``clip``}; a ``grad_seed`` marker keeps
only the clip evidence and adds its kind; a ``noise`` marker replaces
taint with its own site token; a ``sample_idx`` marker launders it; a
draw from a generator outputs {``key``}. Backward passes are recorded op
by op, so a seed's taint reaches the gradients through the very ops that
form them.

**Checks** (conditional on what the plan declares):

  * clip ⇒ every gradient leaf carries ``clip`` and ``seed:weighted`` and
    no plain/norms seed; the clip marker's input carries ``seed:norms``
    and its meta matches the plan's C and granularity;
  * noise ⇒ exactly one noise token per leaf (per segment of per-tenant
    noise), one marker per leaf overall, no noise in the input of any
    all-reduce (``noise-before-psum``: noise added on a rank before the
    gradient sum), meta (σ, scale) equal to the plan's σ and sensitivity;
  * generators — the port's keys are ``torch.Generator`` states: every
    draw names a generator (else ``unkeyed-randomness``), marked
    ``rng_use`` before it (else the draw is outside the audited path), that
    a consumer brought or that was seeded from a consumer's draw (else it
    was born inside the step); two draws at one (generator state, offset)
    — the same state met twice, e.g. ``tenant_generator(seed, t)`` built
    twice for one t — are a ``key-reuse``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import _trace as _T
from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.core.provenance import (KNOWN_TAGS, TAG_CLIP, TAG_GLEAF,
                                         TAG_NOISE, TAG_RNG, TAG_SAMPLE,
                                         TAG_SEED)

PASS = "privacy"
_EMPTY = _T.EMPTY

#: taint tokens
T_CLIP = "clip"
T_KEY = "key"


def _seed_tok(kind: str) -> str:
    return f"seed:{kind}"


@dataclasses.dataclass(frozen=True)
class MarkSite:
    """One provenance marker met during the walk."""
    index: int
    tag: str
    meta: dict
    in_taint: frozenset
    token: Optional[str] = None     # the taint token this site emits


@dataclasses.dataclass(frozen=True)
class LeafLineage:
    """What one gradient leaf's value derives from."""
    path: str
    taint: frozenset

    @property
    def noise_tokens(self) -> Tuple[str, ...]:
        return tuple(sorted(t for t in self.taint if t.startswith("noise:")))


@dataclasses.dataclass(frozen=True)
class PrivacyReport:
    marks: Tuple[MarkSite, ...]
    leaves: Tuple[LeafLineage, ...]
    findings: Tuple[Finding, ...]

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        by_tag: Dict[str, int] = {}
        for m in self.marks:
            by_tag[m.tag] = by_tag.get(m.tag, 0) + 1
        head = (f"privacy: {len(self.leaves)} gradient leaves, markers "
                + (", ".join(f"{k}×{v}" for k, v in sorted(by_tag.items()))
                   or "none"))
        return "\n".join([head] + [f"  {f.render()}" for f in self.findings])


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

class _PrivacyWalker(_T.Walker):
    """Marker-anchored taint propagation + draw and all-reduce audit."""

    def __init__(self, trace: _T.StepTrace):
        self.trace = trace
        self.marks: List[MarkSite] = []
        self.findings: List[Finding] = []
        self.noise_segment: Dict[str, Optional[int]] = {}
        self.draw_keys: Dict[tuple, List[str]] = {}
        self._purpose: Dict[int, str] = {}      # gen id → last purpose
        self._psum_flagged = False

    def hook(self, op, in_t):
        if op.kind == "mark":
            return self._mark(op, in_t)
        if op.kind == "draw":
            return self._draw(op)
        if op.kind == "collective" and not self._psum_flagged and any(
                t.startswith("noise:") for t in in_t[0]):
            self._psum_flagged = True
            self.findings.append(Finding(
                PASS, ERROR, "noise-before-psum",
                "noise reaches the input of an all-reduce — i.e. it is "
                "added per rank, BEFORE the cross-rank gradient sum: "
                "summing rank-local noise inflates the variance by the "
                "shard count and breaks the σ·C calibration"))
        return None

    def _draw(self, op):
        gid = op.meta["gen"]
        if gid is None:
            self.findings.append(Finding(
                PASS, ERROR, "unkeyed-randomness",
                f"a {op.name} draw names no generator: it draws from the "
                f"global RNG, so the step is not a function of its "
                f"declared generators and is not replayable"))
            return [_EMPTY for _ in op.outs]
        g = self.trace.gens[gid]
        if not g.marked:
            self.findings.append(Finding(
                PASS, ERROR, "unkeyed-randomness",
                f"a {op.name} draw uses a generator no rng_use marker "
                f"names: it is consumed outside the audited path"))
        elif g.consumer is None and not g.keyed_seed:
            self.findings.append(Finding(
                PASS, ERROR, "unkeyed-randomness",
                "a generator is created and seeded inside the step from no "
                "draw of a consumer's generator; generators must enter as "
                "consumer arguments (Noise/Importance rng) or derive from "
                "one, so replay and the single-use check can see them"))
        self.draw_keys.setdefault(op.meta["key"], []).append(
            self._purpose.get(gid, "?"))
        return [frozenset({T_KEY}) for _ in op.outs]

    def _mark(self, op, in_t):
        tag = op.name
        meta = op.meta
        t_in = in_t[0] if in_t else _EMPTY
        token = None
        out = t_in
        if tag == TAG_CLIP:
            token = T_CLIP
            out = frozenset({T_CLIP})
        elif tag == TAG_SEED:
            token = _seed_tok(meta.get("kind", "?"))
            # keep only the clip evidence: a weighted seed built from clip
            # coefficients proves per-example scaling
            out = (t_in & frozenset({T_CLIP})) | {token}
        elif tag == TAG_NOISE:
            token = f"noise:{op.index}"
            self.noise_segment[token] = meta.get("segment")
            out = frozenset({token})
        elif tag == TAG_RNG:
            token = T_KEY
            purpose = meta.get("purpose")
            idx = meta.get("index")
            self._purpose[meta["gen"]] = (f"{purpose}[{idx}]"
                                          if idx is not None else purpose)
        elif tag == TAG_GLEAF:
            pass                        # plan/apply boundary: identity
        elif tag == TAG_SAMPLE:
            # selection boundary: a gather does not *scale* anything
            out = _EMPTY
        else:
            self.findings.append(Finding(
                PASS, ERROR, "unknown-marker",
                f"marker tag {tag!r} is not one of {sorted(KNOWN_TAGS)}; a "
                f"marker was added without teaching the privacy pass its "
                f"semantics"))
        self.marks.append(MarkSite(len(self.marks), tag, meta, t_in, token))
        for tid in op.outs:
            self.replace(tid, out)
        return []


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def analyze_trace(trace: _T.StepTrace) -> PrivacyReport:
    """Run the privacy-flow checks on one ``StepTrace``."""
    plan = trace.plan
    walker = _PrivacyWalker(trace)
    walker.run(trace, {})

    findings = list(walker.findings)
    marks = walker.marks
    clip_marks = [m for m in marks if m.tag == TAG_CLIP]
    noise_marks = [m for m in marks if m.tag == TAG_NOISE]
    rng_marks = [m for m in marks if m.tag == TAG_RNG]

    leaves = [LeafLineage(path, walker.taint(tid))
              for path, tid in trace.grad_outputs()]

    # -- clip: per-example scaling before the batch sum --------------------
    if plan.clip is not None:
        gran = plan.clip.granularity
        if not clip_marks:
            findings.append(Finding(
                PASS, ERROR, "clip-missing",
                f"plan declares Clip({plan.clip.clip_norm}) but the trace "
                f"contains no clip_coef marker: no per-example clip "
                f"coefficient was ever computed"))
        for m in clip_marks:
            if m.meta.get("clip_norm") != plan.clip.clip_norm:
                findings.append(Finding(
                    PASS, ERROR, "clip-norm-mismatch",
                    f"clip coefficients use C={m.meta.get('clip_norm')} "
                    f"but the plan declares C={plan.clip.clip_norm}"))
            if m.meta.get("granularity") != gran:
                findings.append(Finding(
                    PASS, ERROR, "clip-granularity-mismatch",
                    f"clip coefficients are "
                    f"{m.meta.get('granularity')}-granular but the plan "
                    f"declares {gran} clipping"))
            if _seed_tok("norms") not in m.in_taint:
                findings.append(Finding(
                    PASS, ERROR, "clip-not-from-norms",
                    "clip coefficients are not derived from the "
                    "norms-seeded backward: min(1, C/‖g‖) must be a "
                    "function of the per-example gradient norms"))
        for lf in leaves:
            # frozen leaf: no backward seed ever reaches it (a frozen LoRA
            # base); nothing per-example flows into the sum through it
            if not any(t == T_CLIP or t.startswith("seed:")
                       for t in lf.taint):
                continue
            if T_CLIP not in lf.taint or \
                    _seed_tok("weighted") not in lf.taint:
                findings.append(Finding(
                    PASS, ERROR, "unclipped-leaf",
                    "gradient is not scaled by the per-example clip "
                    "coefficient before the batch sum (no clip-weighted "
                    "seed in its lineage) — DP sensitivity is unbounded "
                    "for this leaf", leaf=lf.path))
            stray = {_seed_tok("plain"), _seed_tok("norms")} & lf.taint
            if stray:
                findings.append(Finding(
                    PASS, ERROR, "unclipped-leaf",
                    f"an unweighted backward seed ({', '.join(sorted(stray))}"
                    f") reaches this gradient: some per-example "
                    f"contribution enters the batch sum unclipped",
                    leaf=lf.path))
    elif clip_marks:
        findings.append(Finding(
            PASS, WARNING, "unexpected-clip",
            f"{len(clip_marks)} clip_coef marker(s) in a plan that "
            f"declares no Clip consumer"))

    # -- noise: exactly once, after the all-reduce, at σ·C -----------------
    want_noise = plan.noise is not None and plan.needs_grads
    if want_noise:
        sens = plan.noise.scale if plan.noise.scale is not None \
            else plan.clip.clip_norm
        segs = plan.noise.segments
        n_seg = 1 if segs is None else len(segs)
        if len(noise_marks) != len(leaves) * n_seg:
            findings.append(Finding(
                PASS, ERROR, "noise-count",
                f"{len(noise_marks)} noise marker(s) for {len(leaves)} "
                f"gradient leaves × {n_seg} segment(s); DP-SGD noises every "
                f"leaf exactly once"))
        for m in noise_marks:
            if m.meta.get("noise_std") != plan.noise.noise_std:
                findings.append(Finding(
                    PASS, ERROR, "noise-scale-mismatch",
                    f"noise marker carries σ={m.meta.get('noise_std')} but "
                    f"the plan declares σ={plan.noise.noise_std}"))
            if m.meta.get("scale") != sens:
                findings.append(Finding(
                    PASS, ERROR, "noise-scale-mismatch",
                    f"noise marker carries sensitivity "
                    f"{m.meta.get('scale')} but the plan's sensitivity is "
                    f"{sens} (σ·C calibration)"))
        for lf in leaves:
            by_seg: Dict[Optional[int], int] = {}
            for t in lf.noise_tokens:
                s = walker.noise_segment.get(t)
                by_seg[s] = by_seg.get(s, 0) + 1
            if not by_seg and lf.taint:
                findings.append(Finding(
                    PASS, ERROR, "noise-missing",
                    "no noise sample reaches this gradient leaf",
                    leaf=lf.path))
            elif any(n > 1 for n in by_seg.values()):
                n = max(by_seg.values())
                findings.append(Finding(
                    PASS, ERROR, "double-noise",
                    f"{n} independent noise samples reach this gradient "
                    f"leaf; noising twice doubles the variance while the "
                    f"accountant assumes σ·C", leaf=lf.path))
    else:
        if noise_marks:
            findings.append(Finding(
                PASS, ERROR, "unexpected-noise",
                f"{len(noise_marks)} noise marker(s) in a plan that "
                f"declares no Noise consumer"))
        for lf in leaves:
            if lf.noise_tokens:
                findings.append(Finding(
                    PASS, ERROR, "unexpected-noise",
                    "a noise sample reaches this gradient leaf but the "
                    "plan declares no Noise consumer", leaf=lf.path))

    # -- generators: single use --------------------------------------------
    for key, uses in walker.draw_keys.items():
        if key is not None and len(uses) > 1:
            findings.append(Finding(
                PASS, ERROR, "key-reuse",
                f"one generator state is drawn {len(uses)} times "
                f"({', '.join(uses)}): reusing a key correlates draws that "
                f"DP accounting assumes independent"))
    if want_noise and not any(m.meta.get("purpose") == "noise"
                              for m in rng_marks):
        findings.append(Finding(
            PASS, ERROR, "unkeyed-randomness",
            "the plan declares Noise but no rng_use(purpose=noise) marker "
            "appears: the noise generator is consumed outside the audited "
            "path"))
    if plan.importance is not None and not any(
            m.meta.get("purpose") == "importance" for m in rng_marks):
        findings.append(Finding(
            PASS, ERROR, "unkeyed-randomness",
            "the plan declares Importance but no "
            "rng_use(purpose=importance) marker appears"))

    return PrivacyReport(tuple(marks), tuple(leaves), tuple(findings))


def check_step(loss_fn, params, batch, consumers, **trace_kw):
    """Convenience: trace ``Engine.step`` and analyze it."""
    return analyze_trace(_T.trace_step(loss_fn, params, batch, consumers,
                                       **trace_kw))
