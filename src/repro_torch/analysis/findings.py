"""Structured lint findings — the machine-readable unit every pexlint
pass reports in (DESIGN.md §12).

A ``Finding`` is one verdict from one pass about one place: severity,
a stable ``code`` (what rule fired), the model/granularity the trace
came from, and — when the rule is about a specific gradient leaf — the
parameter path. ``python -m repro_torch.analysis --json`` emits these
verbatim for CI annotation; the human CLI renders them as lines.

Port of ``src/repro/analysis/findings.py``: the same record and the same
``render()`` text.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verdict from one static pass."""
    pass_: str                      # coverage | launch | privacy | ...
    severity: str                   # error | warning | info
    code: str                       # stable rule id, kebab-case
    message: str
    model: Optional[str] = None
    granularity: Optional[str] = None
    leaf: Optional[str] = None      # parameter-leaf path, when leaf-scoped

    def to_json(self) -> dict:
        d = {"pass": self.pass_, "severity": self.severity,
             "code": self.code, "message": self.message}
        for k in ("model", "granularity", "leaf"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    def render(self) -> str:
        where = "".join(
            f" [{v}]" for v in (self.model, self.granularity, self.leaf)
            if v is not None)
        return f"{self.severity.upper()} {self.pass_}/{self.code}" \
               f"{where}: {self.message}"


def errors(findings: Sequence[Finding]) -> Tuple[Finding, ...]:
    return tuple(f for f in findings if f.severity == ERROR)


def warnings_(findings: Sequence[Finding]) -> Tuple[Finding, ...]:
    return tuple(f for f in findings if f.severity == WARNING)


def tag(findings: Sequence[Finding], *, model: Optional[str] = None,
        granularity: Optional[str] = None) -> Tuple[Finding, ...]:
    """Fill in model/granularity on findings that lack them (passes
    report location-agnostically; the caller knows the trace's
    provenance)."""
    return tuple(
        dataclasses.replace(
            f,
            model=f.model if f.model is not None else model,
            granularity=(f.granularity if f.granularity is not None
                         else granularity))
        for f in findings)
