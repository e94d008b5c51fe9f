"""Tap-coverage verifier: prove, at trace time, that the taps cover the
parameter tree (pexlint pass 1, DESIGN.md §10).

Port of ``src/repro/analysis/coverage.py``. The paper's exactness claim is
only as good as the instrumentation: a parameter whose gradient path
bypasses every Tap op contributes to training but not to the per-example
norms — DP clipping silently under-clips and GNS/importance estimates
bias. Running the model cannot show that (the norms are merely
*smaller*), but a trace can: this pass records ``loss_fn(params, batch,
tap)`` with a live tap on ``meta`` tensors (``analysis._trace``) and
classifies every parameter leaf by taint analysis.

**Taint propagation.** Each tensor carries the set of parameter leaves it
(transitively) depends on; every op unions its operands' taint into its
outputs (``_trace.Walker``). A Tap site (identified by its
``autograd.Function`` — ``core.taps.PEX_OPS``) is the one place taint is
*blocked*: the weight-slot operand's taint is captured as a tap site and
does NOT flow into the op's output, while data-slot taint flows through;
the ops of the site's own forward are not walked. ``detach`` blocks too:
no gradient flows back through it (a frozen LoRA base weight). After
propagation:

  * leaf taint reaches the loss        ⇒ **untapped-but-trained**: some
    gradient path avoids every tap (ERROR unless allowlisted);
  * leaf captured at a tap site only   ⇒ **tapped** (OK);
  * leaf taint reaches nothing          ⇒ **frozen/unused** (OK).

A leaf that is both captured *and* reaches the loss is still an error —
its norm undercounts the plain path.

**Allowlist.** Intentionally untapped parameters must be *declared*:
``allow`` entries are keys matched against the components of the leaf's
key path (``models.registry.UNTAPPED_ALLOWLIST``, the same rule as
``registry.scope_mask``; the reference matches substrings of its path
string). An entry that matches no parameter path is *stale* and reported
in ``CoverageReport.stale_allow``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import _trace as _T
from repro_torch.analysis._trace import AnalysisError  # noqa: F401
from repro_torch.core.taps import ExampleLayout, PexSpec, Tap
from repro_torch.nn.param import tree_leaves, tree_paths

_EMPTY = _T.EMPTY


# ---------------------------------------------------------------------------
# report datatypes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TapSite:
    """One instrumented op in the traced program."""
    index: int
    op: str                         # dense | bias_add | scale | ...
    param_leaves: frozenset         # leaf ids captured in the weight slot
    operand_avals: Tuple            # (shape, dtype name) per operand


#: classification outcomes
TAPPED = "tapped"
UNTAPPED = "untapped-but-trained"
FROZEN = "frozen/unused"


@dataclasses.dataclass(frozen=True)
class LeafReport:
    path: str                       # display path (a/0/b)
    shape: Tuple[int, ...]
    status: str                     # TAPPED | UNTAPPED | FROZEN
    allowlisted: bool
    sites: Tuple[int, ...]          # TapSite indices capturing this leaf

    @property
    def is_error(self) -> bool:
        return self.status == UNTAPPED and not self.allowlisted


@dataclasses.dataclass(frozen=True)
class CoverageReport:
    leaves: Tuple[LeafReport, ...]
    sites: Tuple[TapSite, ...]
    token_loss_registered: bool
    stale_allow: Tuple[str, ...] = ()   # allow entries matching no leaf

    @property
    def errors(self) -> Tuple[LeafReport, ...]:
        return tuple(l for l in self.leaves if l.is_error)

    @property
    def ok(self) -> bool:
        return not self.errors

    def counts(self) -> dict:
        out = {TAPPED: 0, UNTAPPED: 0, FROZEN: 0, "allowlisted": 0}
        for l in self.leaves:
            if l.status == UNTAPPED and l.allowlisted:
                out["allowlisted"] += 1
            else:
                out[l.status] += 1
        return out

    def summary(self) -> str:
        c = self.counts()
        head = (f"{len(self.sites)} tap sites; {c[TAPPED]} tapped, "
                f"{c['allowlisted']} allowlisted-untapped, "
                f"{c[FROZEN]} frozen, {c[UNTAPPED]} ERROR")
        lines = [head]
        for l in self.errors:
            lines.append(
                f"  ERROR untapped-but-trained: {l.path} {l.shape} — its "
                f"gradient path reaches the loss without crossing any tap "
                f"op, so per-example norms undercount it; tap it or add "
                f"it to the allowlist")
        for a in self.stale_allow:
            lines.append(
                f"  WARNING stale allowlist entry {a!r}: matches no "
                f"parameter path in this model — remove it, or it will "
                f"silently mask the next parameter named like it")
        return "\n".join(lines)

    def raise_if_errors(self) -> "CoverageReport":
        if not self.ok:
            raise AnalysisError("tap coverage failed:\n" + self.summary())
        return self


# ---------------------------------------------------------------------------
# the walker — tap semantics over the shared front end
# ---------------------------------------------------------------------------

class _CoverageWalker(_T.Walker):
    """Union-taint walker that blocks weight taint at tap sites."""

    def __init__(self):
        self.sites: list = []

    def hook(self, op, in_t):
        if op.site >= 0:
            return []                   # the site's record stands for it
        if op.kind == "aten" and op.name in _T.DETACH_OPS:
            return [_EMPTY for _ in op.outs]
        if op.kind != "tap":
            return None
        info = op.meta["info"]
        captured = _EMPTY
        for ws in info.weight_slots:
            captured = captured | in_t[ws]
        avals = tuple((self.tensors[t].shape, self.tensors[t].dtype)
                      for t in op.ins)
        self.sites.append(TapSite(len(self.sites), info.name, captured,
                                  avals))
        data = _EMPTY
        for ds in info.data_slots:
            data = data | in_t[ds]
        # outputs are (z, acc): weight taint is *blocked*
        return [data, in_t[-1]]


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _leading_dim(tree) -> int:
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        raise ValueError("cannot infer batch size from an empty batch")
    return leaves[0].shape[0]


def _matches(entry: str, path) -> bool:
    return entry in {str(k) for k in path}


def stale_allow_entries(allow: Sequence[str], paths) -> Tuple[str, ...]:
    """``allow`` entries that match no leaf path (key paths, as
    ``tree_paths`` gives them): an entry is stale iff it can never
    fire."""
    return tuple(a for a in allow if not any(_matches(a, p) for p in paths))


def trace_coverage(loss_fn: Callable, params, batch, *,
                   spec: Optional[PexSpec] = None, layout=None,
                   batch_size: Optional[int] = None,
                   allow: Sequence[str] = (),
                   tap_factory: Optional[Callable] = None) -> CoverageReport:
    """Classify every parameter leaf of ``loss_fn(params, batch, tap)`` as
    tapped / untapped-but-trained / frozen. Trace-only: ``params`` and
    ``batch`` may live on any device (``meta`` included); nothing is
    computed. ``tap_factory(spec, acc=..., layout=...)`` substitutes a
    custom collector (the mutation tests inject site-deleting taps)."""
    spec = spec if spec is not None else PexSpec(enabled=True)
    if not spec.enabled:
        raise ValueError(
            "tap coverage needs a live tap: spec.enabled=False would "
            "classify every trained parameter as untapped")
    layout = layout if layout is not None else ExampleLayout(spec.n_groups)
    factory = tap_factory if tap_factory is not None else Tap
    mparams, mbatch = _T.to_meta(params), _T.to_meta(batch)
    b = batch_size if batch_size is not None else _leading_dim(mbatch)

    leaves = tree_leaves(mparams)
    paths = tree_paths(mparams)
    rec = _T.Recorder()
    with rec:
        tap = factory(spec, acc=layout.init(b, "meta"), layout=layout)
        loss_vec, _aux = loss_fn(mparams, mbatch, tap)
        token = tap.token_losses() is not None
        loss = torch.sum(loss_vec)
        loss_id = rec.tid(loss)
        init = {rec.tid(x): frozenset((i,)) for i, x in enumerate(leaves)
                if isinstance(x, torch.Tensor)}
    walker = _CoverageWalker()
    walker.run(_T.Trace.of(rec), init)
    sites = walker.sites
    loss_taint = walker.taint(loss_id)

    reports = []
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        if not isinstance(leaf, torch.Tensor):
            continue
        captured = tuple(s.index for s in sites if i in s.param_leaves)
        if i in loss_taint:
            status = UNTAPPED
        elif captured:
            status = TAPPED
        else:
            status = FROZEN
        allowed = status == UNTAPPED and any(_matches(a, path)
                                             for a in allow)
        reports.append(LeafReport(_T.path_str(path), tuple(leaf.shape),
                                  status, allowed, captured))
    return CoverageReport(tuple(reports), tuple(sites), token,
                          stale_allow_entries(allow, paths))
