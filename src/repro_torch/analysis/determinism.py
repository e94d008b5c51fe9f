"""Determinism verification of the data pipeline and replay path
(pexlint pass, DESIGN.md §12).

Port of ``src/repro/analysis/determinism.py``, with torch's global-state
RNG added to what it forbids. The fault-tolerance story (``ft``,
``launch/soak.py``) rests on one
property of the data layer: every batch is a pure function of
``(seed, step)``. Resume-from-checkpoint replays the exact token
stream because the only persisted cursor IS the step counter; the soak
harness's INV2 replay check and the elastic renumbering proof both
assume it. The property is easy to break silently — a cached iterator,
a wall-clock-salted seed, one call to the legacy global numpy RNG —
and nothing fails until a recovery trains on different data than the
uninterrupted run would have seen.

This pass checks the property statically, over the *source* of the
stream functions (``ast``, no execution):

  * **forbidden-call** — wall-clock (``time.time``/``datetime.now``),
    process entropy (``os.urandom``, ``secrets``, ``uuid``), the
    stdlib ``random`` module, and numpy's legacy global-state RNG
    (``np.random.<anything>`` except the seeded constructor family
    ``default_rng``/``Generator``/``SeedSequence``/bit generators), and
    torch's global-state draws: ``torch.rand*``, ``torch.randn*``,
    ``torch.randint*``, ``torch.randperm``, ``torch.normal`` (and the other
    sampling functions) and the in-place ``Tensor.*_`` draws called
    without ``generator=``;
  * **global-seed** — ``torch.manual_seed`` / ``torch.seed`` (and the
    ``cuda`` / ``random`` forms) inside a step-indexed function: reseeding
    the process-wide RNG makes every later draw anywhere depend on call
    history;
  * **unseeded-rng** — ``default_rng()`` with no seed argument draws
    OS entropy;
  * **unstable-hash** — the ``hash()`` builtin is salted per process
    (PYTHONHASHSEED) and must never feed a seed;
  * **iterator-state** — stream classes may not mutate ``self``
    outside ``__init__``/``__post_init__``: any per-call cursor makes
    ``batch_at(step)`` depend on call history, not on ``step``;
  * **global-state** — ``global``/``nonlocal`` writes are call-history
    by another name;
  * **seed-ignores-step** — a function taking a ``step`` parameter
    that constructs an RNG (``default_rng``/``PRNGKey``/``fold_in``, and
    the port's ``manual_seed``/``fold_seed``) must feed ``step`` into that
    construction, else every step replays the same stream position (or
    worse, an ambient one).

``check_source`` is the unit (mutation-testable on source snippets);
``analyze`` applies it to the shipping targets: the whole
``repro_torch.data.pipeline`` module and the soak harness's replay probe
``SoakWorld._probe_batch``.
"""
from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import ERROR, Finding

PASS = "determinism"

#: dotted-call prefixes that are never (seed, step)-pure. Matched
#: textually against the source's attribute chain — the repo's idiom
#: (``import numpy as np``, stdlib modules by name) makes this exact.
_FORBIDDEN_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("time.time", "wall-clock"),
    ("time.time_ns", "wall-clock"),
    ("time.monotonic", "wall-clock"),
    ("time.perf_counter", "wall-clock"),
    ("datetime.datetime.now", "wall-clock"),
    ("datetime.datetime.utcnow", "wall-clock"),
    ("datetime.date.today", "wall-clock"),
    ("os.urandom", "process entropy"),
    ("os.getrandom", "process entropy"),
    ("secrets.", "process entropy"),
    ("uuid.uuid1", "process entropy"),
    ("uuid.uuid4", "process entropy"),
    ("random.", "stdlib global RNG"),
)

#: the seeded-constructor family under np.random that IS allowed;
#: everything else there is the legacy global-state RNG
_NP_RANDOM_ALLOWED = frozenset({
    "default_rng", "Generator", "SeedSequence",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
})

#: torch's sampling functions and in-place draws: global-state RNG unless
#: called with ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
})
_TENSOR_DRAWS = frozenset({
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})
#: reseeding torch's process-wide RNG
_GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})

#: RNG constructors whose seed must involve ``step`` inside a
#: step-indexed stream function
_RNG_CONSTRUCTORS = frozenset({"default_rng", "PRNGKey", "fold_in",
                               "manual_seed", "fold_seed"})

#: methods allowed to write ``self`` — one-time setup, not per-call
_SETUP_METHODS = frozenset({"__init__", "__post_init__", "__new__"})


def _dotted(node: ast.AST) -> Optional[str]:
    """``np.random.default_rng`` → that string; None for non-chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node: ast.AST) -> frozenset:
    return frozenset(n.id for n in ast.walk(node)
                     if isinstance(n, ast.Name))


class _Checker(ast.NodeVisitor):
    def __init__(self, target: str):
        self.target = target
        self.findings: List[Finding] = []
        self._class: Optional[str] = None
        self._func: List[str] = []
        self._step_fn = 0           # enclosing functions taking ``step``

    def _err(self, code: str, node: ast.AST, msg: str) -> None:
        where = ".".join(filter(None, [self._class] + self._func)) \
            or "<module>"
        self.findings.append(Finding(
            PASS, ERROR, code,
            f"{self.target}:{node.lineno} ({where}): {msg}"))

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name:
            for prefix, why in _FORBIDDEN_PREFIXES:
                if name == prefix or name.startswith(prefix + ".") \
                        or (prefix.endswith(".")
                            and name.startswith(prefix)):
                    self._err("forbidden-call", node,
                              f"call to {name} ({why}) — batches must "
                              f"be pure in (seed, step)")
                    break
            else:
                self._np_random(name, node)
                self._torch_random(name, node)
        if isinstance(node.func, ast.Name) and node.func.id == "hash":
            self._err("unstable-hash", node,
                      "hash() is salted per process (PYTHONHASHSEED); "
                      "seed material must use a stable mix")
        if name and name.split(".")[-1] == "default_rng" \
                and not node.args:
            self._err("unseeded-rng", node,
                      "default_rng() with no seed draws OS entropy; "
                      "pass a (seed, step, ...) tuple")
        self.generic_visit(node)

    def _np_random(self, name: Optional[str], node: ast.Call) -> None:
        if not name:
            return
        for root in ("np.random.", "numpy.random.", "jnp.random."):
            if name.startswith(root):
                tail = name[len(root):].split(".")[0]
                if tail not in _NP_RANDOM_ALLOWED:
                    self._err("forbidden-call", node,
                              f"call to {name} uses numpy's legacy "
                              f"global-state RNG; use a "
                              f"default_rng((seed, step, ...)) stream")
                return

    def _torch_random(self, name: str, node: ast.Call) -> None:
        if name in _GLOBAL_SEEDS:
            if self._step_fn:
                self._err("global-seed", node,
                          f"call to {name} inside a step: reseeding the "
                          f"process-wide RNG makes every later draw "
                          f"depend on call history")
            return
        if any(kw.arg == "generator" for kw in node.keywords):
            return
        parts = name.split(".")
        tail = parts[-1]
        torch_fn = (len(parts) == 2 and parts[0] == "torch"
                    and tail in _TORCH_DRAWS)
        if torch_fn or (len(parts) >= 2 and tail in _TENSOR_DRAWS):
            self._err("forbidden-call", node,
                      f"call to {name} without generator= draws from "
                      f"torch's global-state RNG; draw from a "
                      f"torch.Generator seeded from (seed, step, ...)")

    # -- state ------------------------------------------------------------
    def _self_write(self, target: ast.AST) -> bool:
        return (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self")

    def _check_store(self, targets: Sequence[ast.AST],
                     node: ast.AST) -> None:
        if not self._func or self._func[-1] in _SETUP_METHODS:
            return
        for t in targets:
            if self._self_write(t):
                self._err("iterator-state", node,
                          f"stream method mutates self.{t.attr}: a "
                          f"per-call cursor makes output depend on "
                          f"call history, not on step")

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_store(node.targets, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store([node.target], node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_store([node.target], node)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self._err("global-state", node,
                  f"global {', '.join(node.names)}: module state is "
                  f"call history by another name")

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._err("global-state", node,
                  f"nonlocal {', '.join(node.names)} in a stream "
                  f"function")

    # -- structure --------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, node.name
        self.generic_visit(node)
        self._class = prev

    def _function(self, node) -> None:
        step = "step" in {a.arg for a in node.args.args
                          + node.args.kwonlyargs}
        self._func.append(node.name)
        self._step_fn += step
        self.generic_visit(node)
        self._step_fn -= step
        self._func.pop()
        self._step_purity(node)

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    def _step_purity(self, fn) -> None:
        """A step-indexed function that builds an RNG must feed
        ``step`` into the construction."""
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        if "step" not in params:
            return
        ctors = [c for c in ast.walk(fn)
                 if isinstance(c, ast.Call)
                 and (_dotted(c.func) or "").split(".")[-1]
                 in _RNG_CONSTRUCTORS]
        seeded = [c for c in ctors if any(
            "step" in _names_in(a)
            for a in list(c.args) + [kw.value for kw in c.keywords])]
        if ctors and not seeded:
            self._err("seed-ignores-step", ctors[0],
                      f"{fn.name}(step) constructs an RNG whose seed "
                      f"never references step: every step would replay "
                      f"the same stream position")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def check_source(src: str, name: str) -> Tuple[Finding, ...]:
    """Run the purity checks over one source blob (a module or a
    dedented function). The unit the mutation corpus drives."""
    tree = ast.parse(textwrap.dedent(src))
    checker = _Checker(name)
    checker.visit(tree)
    return tuple(checker.findings)


@dataclasses.dataclass(frozen=True)
class DeterminismTarget:
    name: str
    lines: int


@dataclasses.dataclass(frozen=True)
class DeterminismReport:
    targets: Tuple[DeterminismTarget, ...]
    findings: Tuple[Finding, ...]

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        head = (f"determinism: {len(self.targets)} target(s), "
                f"{sum(t.lines for t in self.targets)} lines checked")
        return "\n".join([head] + [f"  {f.render()}"
                                   for f in self.findings])


def _default_targets() -> List[Tuple[str, str]]:
    import repro_torch.data.pipeline as pipeline
    from repro_torch.launch.soak import SoakWorld
    return [
        ("data/pipeline.py", inspect.getsource(pipeline)),
        ("launch/soak.py::SoakWorld._probe_batch",
         inspect.getsource(SoakWorld._probe_batch)),
    ]


def analyze(targets: Optional[Sequence[Tuple[str, str]]] = None
            ) -> DeterminismReport:
    """Check the shipping replay surface: the whole data pipeline plus
    the soak harness's probe-batch path (the function INV2 replays
    through). ``targets`` overrides as ``(name, source)`` pairs."""
    pairs = list(targets) if targets is not None else _default_targets()
    findings: List[Finding] = []
    checked = []
    for name, src in pairs:
        findings.extend(check_source(src, name))
        checked.append(DeterminismTarget(name, src.count("\n") + 1))
    return DeterminismReport(tuple(checked), tuple(findings))
