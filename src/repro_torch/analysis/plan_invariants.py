"""Plan-invariant analyzers: the zero-overhead and one-forward-budget
claims, pinned by the cost of a recorded program (pexlint pass 2,
DESIGN.md §10).

Port of ``src/repro/analysis/plan_invariants.py``. The pure arithmetic
``check_*`` functions are the reference's, unchanged. The ``assert_*``
level measures, where the reference compiled HLO and read XLA's cost
analysis, the flops and bytes of a *recorded* program instead: the
program runs once on ``meta`` tensors under ``analysis._trace``'s
recorder and ``analysis.traffic.program_cost`` sums its ops (a kernel
site at its launch contract). So every ``assert_*`` here is trace-only.

  * a DISABLED spec records the plain model's ops;
  * an ENABLED spec whose stats nobody reads costs no more than the plain
    model: the port has no dead-code elimination to remove unread stat
    chains, and runs every backward under a ``BackwardMode`` instead
    (ROADMAP.md, "backward mode instead of DCE") — a live tap whose
    backward is told to form no stat forms none;
  * ``step([])`` records exactly the plain forward;
  * ``step([Grads()])`` costs no more than a plain ``torch.autograd.grad``;
  * the Clip plan fits the one-forward budget
    ``cost(norms) + (cost(grad) − cost(forward))`` within ``BUDGET_TOL``
    — one tapped forward, one activation backward, ONE reweighted
    backward — and Noise + GNS add at most ``EPS_TOL`` over it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis import _trace as _T
from repro_torch.analysis.traffic import program_cost
from repro_torch.core.engine import Engine, infer_batch_size
from repro_torch.core.taps import DISABLED, ExampleLayout, NULL, PexSpec, Tap
from repro_torch.nn.param import tree_leaves

#: "the same program" modulo float accounting noise
EQ_TOL = 1e-6
#: Clip-plan headroom over the 1F + 1aB + 1wB budget
BUDGET_TOL = 0.02
#: Noise+GNS epsilon over the Clip plan alone (O(n_params) extras)
EPS_TOL = 0.25
#: an enabled tap's own bookkeeping when no stat is read: its (B, G)
#: accumulator threaded through each site of the forward, O(sites × B)
#: elements (llama3.2-1b's smoke step: 63 flops of 1.23e7, 5e-6)
TAP_TOL = 1e-4


def cost_of(fn, *args) -> Tuple[float, float]:
    """(flops, bytes) of ``fn(*args)``, recorded on ``meta`` copies."""
    return program_cost(_T.record_program(fn, *args))


def _leaves(params, grad: bool):
    leaves = [x.detach().requires_grad_(grad) for x in tree_leaves(params)]
    from repro_torch.nn.param import tree_flatten, tree_unflatten
    _, treedef = tree_flatten(params)
    return leaves, tree_unflatten(treedef, leaves)


def grad_cost(loss_fn, params, batch,
              spec: Optional[PexSpec]) -> Tuple[float, float]:
    """Cost of the gradient w.r.t. the parameters of the total loss;
    ``spec=None`` runs the inert tap (the plain model), otherwise a live
    Tap whose backward is told to form no stat (its accumulator's gradient
    is never requested)."""
    def total_grad(p, b):
        leaves, p = _leaves(p, True)
        if spec is None:
            lv, _ = loss_fn(p, b, NULL)
        elif not spec.enabled:
            lv, _ = loss_fn(p, b, Tap(spec))    # inert: no accumulator
        else:
            layout = ExampleLayout(spec.n_groups)
            acc = layout.init(infer_batch_size(b),
                              leaves[0].device).requires_grad_()
            tap = Tap(spec, acc=acc, layout=layout)
            tap.set_mode(norms=False, grads=True)
            lv, _ = loss_fn(p, b, tap)
        torch.autograd.grad(torch.sum(lv), leaves, allow_unused=True)
    return cost_of(total_grad, params, batch)


def forward_cost(loss_fn, params, batch) -> Tuple[float, float]:
    """Cost of the plain forward (the inert tap, no gradient)."""
    return program_cost(_T.record_forward(loss_fn, params, batch))


def step_cost(loss_fn, params, batch, consumers: Sequence, *,
              engine: Optional[Engine] = None) -> Tuple[float, float]:
    """Cost of one recorded ``Engine.step`` of ``consumers``."""
    eng = engine if engine is not None else Engine(
        PexSpec(enabled=True, method="gram"))
    return cost_of(lambda p, b: eng.step(loss_fn, p, b, list(consumers)),
                   params, batch)


# ---------------------------------------------------------------------------
# pure checks (cost arithmetic only)
# ---------------------------------------------------------------------------

def check_empty_plan(f_empty: float, f_fwd: float, *,
                     tol: float = EQ_TOL) -> None:
    if f_fwd <= 0.0:
        return
    assert abs(f_empty - f_fwd) <= tol * f_fwd, (
        f"step([]) is not the plain forward: {f_empty} vs {f_fwd}")


def check_grads_plan(f_gonly: float, f_grad: float, *,
                     tol: float = EQ_TOL) -> None:
    assert f_gonly <= f_grad * (1 + tol), (
        f"step([Grads()]) exceeds plain autograd.grad: "
        f"{f_gonly} vs {f_grad}")


def backward_budget(f_norms: float, f_grad: float, f_fwd: float) -> float:
    """The one-forward flop budget for any norm-consuming plan: the
    norms pass already pays one tapped forward + one activation
    backward; a reweighted parameter backward may add at most
    ``cost(plain grad) − cost(plain forward)``."""
    return f_norms + (f_grad - f_fwd)


def check_backward_budget(f_plan: float, f_norms: float, f_grad: float,
                          f_fwd: float, *,
                          tol: float = BUDGET_TOL) -> None:
    budget = backward_budget(f_norms, f_grad, f_fwd)
    assert f_plan <= budget * (1 + tol), (
        f"plan exceeds the one-forward budget (a second forward crept "
        f"in?): {f_plan} vs budget {budget}")


def check_fused_epsilon(f_fused: float, f_base: float, *,
                        tol: float = EPS_TOL) -> None:
    assert f_fused <= f_base * (1 + tol), (
        f"extra consumers are not folding into the base plan: "
        f"{f_fused} vs {f_base}")


def check_dce(f_inst: float, b_inst: float, f_plain: float,
              b_plain: float, *, tol: float = EQ_TOL,
              exact: bool = False) -> None:
    """Instrumented-but-unread stat chains must cost nothing. With
    ``exact`` the programs must match bidirectionally (DISABLED spec);
    otherwise the instrumented program may cost marginally less but never
    more."""
    if exact:
        assert abs(f_inst - f_plain) <= tol * max(f_plain, 1.0), (
            f"disabled taps changed the program: flops {f_inst} vs "
            f"{f_plain}")
        assert abs(b_inst - b_plain) <= tol * max(b_plain, 1.0), (
            f"disabled taps changed the program: bytes {b_inst} vs "
            f"{b_plain}")
    else:
        assert f_inst <= f_plain * (1 + tol), (
            f"unread stat work survived: flops {f_inst} vs {f_plain}")
        assert b_inst <= b_plain * (1 + tol), (
            f"unread stat work survived: bytes {b_inst} vs {b_plain}")


# ---------------------------------------------------------------------------
# record-and-check analyzers (measure, then delegate)
# ---------------------------------------------------------------------------

def assert_disabled_spec_is_plain(loss_fn, params, batch, *,
                                  tol: float = EQ_TOL) -> None:
    """DISABLED taps record the plain model, flop- and byte-exact."""
    f_p, b_p = grad_cost(loss_fn, params, batch, None)
    f_o, b_o = grad_cost(loss_fn, params, batch, DISABLED)
    check_dce(f_o, b_o, f_p, b_p, tol=tol, exact=True)


def assert_unrequested_norms_dce(loss_fn, params, batch, *,
                                 spec: Optional[PexSpec] = None,
                                 tol: float = TAP_TOL) -> None:
    """Taps ENABLED, gradients w.r.t. the parameters only, the backward
    told to form no stat: no flop or byte over the plain model beyond the
    accumulator's own bookkeeping (``TAP_TOL``)."""
    spec = spec if spec is not None else PexSpec(enabled=True,
                                                method="gram")
    f_p, b_p = grad_cost(loss_fn, params, batch, None)
    f_i, b_i = grad_cost(loss_fn, params, batch, spec)
    check_dce(f_i, b_i, f_p, b_p, tol=tol, exact=False)


def assert_empty_plan_is_plain(loss_fn, params, batch, *,
                               engine: Optional[Engine] = None,
                               tol: float = EQ_TOL) -> None:
    """``Engine.step(consumers=[])`` records exactly the plain forward —
    plan analysis with nothing demanded never creates taps."""
    f_fwd, _ = forward_cost(loss_fn, params, batch)
    f_empty, _ = step_cost(loss_fn, params, batch, [], engine=engine)
    check_empty_plan(f_empty, f_fwd, tol=tol)


def assert_grads_plan_is_plain(loss_fn, params, batch, *,
                               engine: Optional[Engine] = None,
                               tol: float = EQ_TOL) -> None:
    """``Engine.step([Grads()])`` costs no more than a plain
    ``torch.autograd.grad`` of the summed loss."""
    from repro_torch.core.plan import Grads
    f_grad, _ = grad_cost(loss_fn, params, batch, None)
    f_g, _ = step_cost(loss_fn, params, batch, [Grads()], engine=engine)
    check_grads_plan(f_g, f_grad, tol=tol)


def assert_backward_budget(loss_fn, params, batch, consumers, *,
                           engine: Optional[Engine] = None,
                           tol: float = BUDGET_TOL) -> None:
    """A norm-consuming plan (Clip and friends) fits the one-forward
    budget: cost(norms pass) + (cost(plain grad) − cost(plain fwd))."""
    from repro_torch.core.plan import Norms
    eng = engine if engine is not None else Engine(
        PexSpec(enabled=True, method="gram"), clip_norm=1.0)
    f_fwd, _ = forward_cost(loss_fn, params, batch)
    f_grad, _ = grad_cost(loss_fn, params, batch, None)
    f_norms, _ = step_cost(loss_fn, params, batch, [Norms()], engine=eng)
    f_plan, _ = step_cost(loss_fn, params, batch, consumers, engine=eng)
    check_backward_budget(f_plan, f_norms, f_grad, f_fwd, tol=tol)


def assert_fused_epsilon(loss_fn, params, batch, base, fused, *,
                         engine: Optional[Engine] = None,
                         tol: float = EPS_TOL) -> None:
    """The consumers of ``fused`` beyond ``base`` (Noise, GNS) fold into
    the base plan at O(n_params) extra work."""
    f_base, _ = step_cost(loss_fn, params, batch, base, engine=engine)
    f_fused, _ = step_cost(loss_fn, params, batch, fused, engine=engine)
    check_fused_epsilon(f_fused, f_base, tol=tol)
