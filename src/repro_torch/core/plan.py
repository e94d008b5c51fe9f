"""Composable consumer plans — one fused pass for everything the norms
already pay for.

Port of ``src/repro/core/plan.py``. ``analyze`` folds a consumer list into
a ``Plan`` and ``execute`` runs it as:

  * one tapped forward, whose autograd graph every backward shares;
  * one backward seeded with ones when a consumer needs norms — the
    norms-only backward (the tap's mode forms no ``dW``);
  * at most one reweighted backward, seeded with the product of clip
    coefficients, importance weights and user loss weights (the tap's mode
    computes no stat, so it launches no norm kernel). With no weights the
    norms and gradients fold into a single backward (paper §4/§5).

``Importance(k, ...)`` splits the plan: a norms-only pass on the candidate
pool, the sample (``core.importance``), the gather, and one gradient pass
on the k-example sub-batch seeded with clip × importance × user weights;
the clip coefficients come from the gathered pool norms, so the sub-batch
pays no second norms pass.

Per-example weights seed the (B,) loss vector. Per-token weights
(``Clip(C, granularity="token")``) seed the (B, S) **per-token loss map**
the loss registers through ``tap.token_loss``, with zeros on the loss
vector: the gradient is then exactly ``Σ_{j,t} w_{j,t} ∂ℓ_{j,t}/∂θ`` by
linearity, ``w`` from the ``TokenLayout`` (B, S) norm map.

The reference applies its ``vjp_fn`` twice; the port makes two
``torch.autograd.grad`` calls over one retained graph: the first over the
initial accumulator, the second over the parameters.

Sharded parameters (the model-axis route): when the parameters are
DTensors (``dist.sharding.distribute_tree`` under ``use_rules(mesh,
rules)``), ``run_fused`` runs the same passes inside a
``dist.sharding.sharded_step``: the batch is laid out by the rules'
``batch`` axis, the accumulator is this rank's rows (a plain tensor, a
partial sum over the mesh dims that do not shard the batch), the per-example
(or per-token) stats are summed over those dims once per backward
(``reduce_acc``), and ``loss_vec``, the norms and the weights come back
whole on every rank; every backward is seeded with the rank's piece of the
whole weights (the token-weighted one with the (B, S) weights laid out as
the registered token map), and each gradient is laid out as its parameter
is. ``Importance`` samples from those whole norms on every rank, so every
rank draws the same indices only from a generator seeded alike on each;
the k-row sub-batch is then laid out by the ``batch`` rule, or replicated
where the batch mesh dims do not divide k.

The mesh path (``dist.pex.plan_step``) hands ``execute`` a ``fused_fn``
that runs the same fused core on each rank's rows and returns global
arrays, so one driver serves both: the importance sample, GNS and the
noise act on global arrays between and after the regions. The ``core.provenance`` markers
sit where the reference's do: every backward's seed is marked
``grad_seed`` with its kind, and the summed gradient ``grad_leaf`` at the
plan/apply boundary; only the analysis passes read them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import spans
from repro_torch.core import importance as imp
from repro_torch.core.clipping import (clip_coefficients,
                                       token_clip_coefficients)
from repro_torch.core.passes import (add_grad_noise,
                                     add_grad_noise_segmented,
                                     check_noise_args)
from repro_torch.core.provenance import mark_grad_tree, mark_seed
from repro_torch.dist import sharding as _sh
from repro_torch.nn.param import tree_flatten, tree_unflatten

# ---------------------------------------------------------------------------
# consumers — the declarative surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Norms:
    """Demand the per-example (B, G) — or per-token (B, S) — squared
    norms in the result."""


@dataclasses.dataclass(frozen=True)
class Grads:
    """Demand the summed gradient (the reweighted one when the plan
    carries weights — a plan produces exactly one)."""


@dataclasses.dataclass(frozen=True)
class Clip:
    """Per-example (or per-token) gradient clipping, two-pass ghost form
    (paper §6): contribute ``min(1, C/‖g_j‖)`` factors to the reweighted
    backward. ``granularity="token"`` clips every token's loss term by its
    (B, S) contribution norm — the token-weighted backward."""
    clip_norm: float
    granularity: str = "example"
    eps: float = 1e-6

    def __post_init__(self):
        if self.granularity not in ("example", "token"):
            raise ValueError(f"Clip granularity must be 'example' or "
                             f"'token', got {self.granularity!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Noise:
    """Gaussian DP-SGD noise σ·scale added once to the summed gradient.
    ``rng`` is a ``torch.Generator`` on the gradients' device; ``scale``
    defaults to the plan's Clip threshold C.

    ``segments`` (optional, (S,) ints) switches to *per-segment* noise for
    gradient trees stacked on a leading segment axis — the multi-tenant
    adapter case: row s of every leaf gets the noise of tenant
    ``segments[s]`` alone, from a generator derived from this step's seed
    (drawn from ``rng``) and the tenant id
    (``passes.add_grad_noise_segmented``). That makes each tenant's DP
    guarantee independent of co-batched tenants."""
    noise_std: float
    rng: Any = None
    scale: Optional[float] = None
    segments: Any = None


@dataclasses.dataclass(frozen=True, eq=False)
class Importance:
    """Importance-sampled sub-batch (Zhao & Zhang; paper §1): norms on the
    candidate pool, sample ``k`` examples ∝ ‖∇L_j‖ with ``rng`` (a
    ``torch.Generator`` on the norms' device), continue the plan on the
    gathered sub-batch with unbiased 1/(k·p_j) weights folded into the
    reweighted backward. On DTensor parameters every rank draws its own
    sample from the whole norms: ``rng`` must be seeded alike on every
    rank, or the ranks gather different sub-batches."""
    k: int
    smoothing: float = 0.1
    rng: Any = None
    replace: bool = True


@dataclasses.dataclass(frozen=True)
class GNS:
    """Gradient-noise-scale telemetry B_simple = tr(Σ)/‖G‖² of the
    gradient estimator the plan produces."""


_KNOWN = (Norms, Grads, Clip, Noise, Importance, GNS)


# ---------------------------------------------------------------------------
# plan analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Static description of the fused pass a consumer list compiles to.
    ``token_norms`` selects the (B, S) accumulator for the norms backward;
    ``token_weighted`` seeds the gradient backward through the registered
    per-token loss map."""
    clip: Optional[Clip] = None
    noise: Optional[Noise] = None
    importance: Optional[Importance] = None
    gns: bool = False
    needs_norms: bool = False
    needs_grads: bool = False
    token_norms: bool = False
    token_weighted: bool = False

    @property
    def weighted(self) -> bool:
        """Does any consumer reweight the backward? (User loss_weights
        add to this at execute time.)"""
        return self.clip is not None or self.importance is not None

    @property
    def n_backwards(self) -> int:
        """Backward passes over one forward's graph (without user
        loss_weights): 0 for the plain forward, 1 when norms and the
        unweighted gradient fold into one seed, 2 when a reweighted
        backward follows the norms pass."""
        if not self.needs_norms and not self.needs_grads:
            return 0
        if not self.needs_norms:
            return 1
        if self.needs_grads and (self.weighted or self.token_weighted):
            return 2
        return 1

    def static_cost(self, *, fwd_flops: Optional[float] = None,
                    param_bytes: Optional[float] = None) -> dict:
        """Structural step-budget estimate from the plan's shape alone:
        flops by the 1-forward/2-backward rule per region, and the
        plan-side full passes over the gradient (its write and the noise
        add; the optimizer adds its own)."""
        regions = 1 if self.importance is None else 2
        grad_reads = int(self.needs_grads) * (
            1 + (1 if self.noise is not None else 0))
        out = {"regions": regions, "backwards": self.n_backwards,
               "grad_stream_reads": grad_reads}
        if fwd_flops is not None:
            out["flops_est"] = float(fwd_flops) * (
                regions + 2.0 * self.n_backwards)
        if param_bytes is not None:
            out["grad_bytes_est"] = float(param_bytes) * (1 + grad_reads)
        return out

    def describe(self, *, fwd_flops: Optional[float] = None,
                 param_bytes: Optional[float] = None) -> str:
        """One-line static cost shape of the pass this plan runs, with the
        ``static_cost`` flop and byte estimates when their inputs are
        given."""
        regions = 1 if self.importance is None else 2
        parts = [f"regions={regions}", f"backwards={self.n_backwards}",
                 "acc=(B,S)" if self.token_norms else
                 ("acc=(B,G)" if self.needs_norms else "acc=none")]
        if self.clip is not None:
            parts.append(f"clip[{self.clip.granularity}]")
        if self.noise is not None:
            parts.append("noise")
        if self.gns:
            parts.append("gns")
        if self.importance is not None:
            parts.append(f"importance(k={self.importance.k})")
        est = self.static_cost(fwd_flops=fwd_flops,
                               param_bytes=param_bytes)
        if "flops_est" in est:
            parts.append(f"flops≈{est['flops_est']:.3g}")
        if "grad_bytes_est" in est:
            parts.append(f"grad_bytes≈{est['grad_bytes_est']:.3g}")
        return " ".join(parts)


def analyze(consumers: Sequence, *,
            engine_granularity: str = "example") -> Plan:
    """Fold a consumer list into a validated Plan."""
    seen = {}
    for c in consumers:
        if not isinstance(c, _KNOWN):
            raise TypeError(
                f"unknown consumer {c!r}; expected instances of "
                f"{', '.join(k.__name__ for k in _KNOWN)}")
        if type(c) in seen:
            raise ValueError(f"duplicate consumer {type(c).__name__}; a "
                             f"plan carries at most one of each kind")
        seen[type(c)] = c

    clip: Optional[Clip] = seen.get(Clip)
    noise: Optional[Noise] = seen.get(Noise)
    importance: Optional[Importance] = seen.get(Importance)
    gns = GNS in seen

    token_norms = engine_granularity == "token" or (
        clip is not None and clip.granularity == "token")
    token_weighted = clip is not None and clip.granularity == "token"
    if clip is not None and clip.granularity == "example" \
            and engine_granularity == "token":
        raise ValueError(
            "Clip(granularity='example') needs per-example norms, but the "
            "engine runs at token granularity; use Clip(C, "
            "granularity='token') or an example-granularity engine")
    if token_norms and gns:
        raise NotImplementedError(
            "GNS needs per-example ‖g_j‖²; the (B, S) token map does not "
            "sum to them (cross-token terms) — run GNS at example "
            "granularity")
    if token_norms and importance is not None:
        raise NotImplementedError(
            "Importance samples examples from per-example norms; it does "
            "not compose with token-granularity norms in one plan — run "
            "the token pass on the selected sub-batch instead")
    if noise is not None:
        check_noise_args(noise.noise_std, noise.rng)
        if noise.scale is None and clip is None:
            raise ValueError(
                "Noise without Clip needs an explicit sensitivity: pass "
                "Noise(σ, rng, scale=...) — σ·scale is the noise stddev")
        if noise.scale is None and token_weighted:
            raise ValueError(
                "Noise cannot default its sensitivity to a token-"
                "granularity Clip's C: per-token clipping bounds each of "
                "the S token terms by C, so an example's total "
                "contribution is bounded by S·C, not C — pass "
                "Noise(σ, rng, scale=...) with the sensitivity your "
                "accounting assumes")

    if importance is not None and importance.rng is None:
        raise ValueError(
            "Importance needs an rng: pass Importance(k, rng=torch."
            "Generator(device=...).manual_seed(...)) — or run through the "
            "Trainer, which gives rng=None consumers a generator each step")

    needs_grads = (Grads in seen or clip is not None or noise is not None
                   or gns)
    needs_norms = (Norms in seen or clip is not None or gns
                   or importance is not None)
    return Plan(clip=clip, noise=noise, importance=importance, gns=gns,
                needs_norms=needs_norms, needs_grads=needs_grads,
                token_norms=token_norms, token_weighted=token_weighted)


class StepResult(NamedTuple):
    """Everything a fused plan produced; fields a plan did not demand are
    None."""
    loss: torch.Tensor                  # Σ_j loss_vec
    loss_vec: torch.Tensor              # (B,) per-example losses
    aux: Any = None
    sq_norms: Optional[torch.Tensor] = None   # (B, G) or (B, S)
    grads: Any = None
    weights: Optional[torch.Tensor] = None    # per-example seed actually used
    token_weights: Optional[torch.Tensor] = None  # (B, S) token seed
    clip_coef: Optional[torch.Tensor] = None  # (B,) or (B, S)
    gns: Optional[torch.Tensor] = None
    sample: Optional[imp.ImportanceSample] = None
    sub_sq_norms: Optional[torch.Tensor] = None  # pool norms on the sub-batch


# ---------------------------------------------------------------------------
# the fused single-region core
# ---------------------------------------------------------------------------

def _grad(out: torch.Tensor, inputs, seed: torch.Tensor, *,
          retain_graph: bool = False):
    """Gradients of ``out`` (seeded) w.r.t. ``inputs``; an input the
    output does not reach gets zeros."""
    gs = torch.autograd.grad(out, inputs, grad_outputs=seed,
                             retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, gs)]


def run_fused(plan: Plan, acc_loss: Callable, params, batch,
              batch_size: int, layout, *, loss_weights=None):
    """One forward, ≤ 2 backward passes. Returns ``(loss_vec, aux,
    sq_norms, grads, weights, token_weights, clip_coef)`` with undemanded
    entries None.

    ``acc_loss(params, acc, batch) -> (loss_vec, token_map | None, tap,
    aux)``; acc=None runs the model with an inert tap. DTensor parameters
    run the sharded route (module docstring), at either granularity."""
    leaves = tree_flatten(params)[0]
    mesh = next((x.device_mesh for x in leaves if _sh.is_dtensor(x)), None)
    if mesh is None:
        return _fused(plan, acc_loss, params, batch, batch_size, layout,
                      loss_weights)
    active, rules = _sh.current_rules()
    if batch_size % _sh.axis_size(_sh.spec("batch")[0], mesh):
        # a batch the batch mesh dims do not divide (an Importance
        # sub-batch of k rows): GSPMD pads an uneven shard, which DTensor
        # does not flatten, so the step runs on the batch replicated
        rules = {**rules, "batch": None}
    with _sh.use_rules(active, rules), \
            _sh.sharded_step(mesh, _sh.batch_mesh_dims(mesh)):
        lv, aux, sq, grads, w, tw, cc = _fused(
            plan, acc_loss, params, _sh.distribute_batch(batch, mesh),
            batch_size, layout, loss_weights, mesh=mesh)
    return lv.full_tensor(), aux, sq, grads, w, tw, cc


def _fused(plan: Plan, acc_loss: Callable, params, batch, batch_size: int,
           layout, loss_weights, mesh=None):
    """``run_fused``'s passes; ``mesh`` (the parameters' DTensor mesh)
    inside a ``dist.sharding.sharded_step``."""
    leaves, treedef = tree_flatten(params)

    def seed_as(lv, w):
        # the whole weights as the loss vector (or the token map) is laid
        # out
        return w if mesh is None else _sh.like(lv, w)

    def unflatten(gs):
        if mesh is not None:
            gs = [g.redistribute(x.device_mesh, x.placements)
                  if _sh.is_dtensor(g) else g for g, x in zip(gs, leaves)]
        return tree_unflatten(treedef, gs)

    if not plan.needs_norms and not plan.needs_grads:
        with spans.span("plan.forward"), torch.no_grad():
            lv, _, _, aux = acc_loss(params, None, batch)
        return lv, aux, None, None, None, None, None

    # detached views: the caller's tensors stay as they are
    leaves = [x.detach().requires_grad_(plan.needs_grads) for x in leaves]
    params = tree_unflatten(treedef, leaves)

    if not plan.needs_norms:
        # gradient pass only (possibly user-weighted): no instrumentation
        with spans.span("plan.forward"):
            lv, _, _, aux = acc_loss(params, None, batch)
        seed = mark_seed(torch.ones_like(lv), kind="plain") \
            if loss_weights is None \
            else mark_seed(seed_as(lv, loss_weights.to(lv.dtype)),
                           kind="weighted")
        with spans.span("plan.backward.grads"):
            grads = unflatten(_grad(lv, leaves, seed))
        return lv.detach(), aux, None, grads, loss_weights, None, None

    if mesh is None:
        acc0 = layout.init(batch_size, leaves[0].device)
    else:
        # this rank's rows of the examples
        acc0 = layout.init(batch_size // _sh.axis_size(
            _sh.spec("batch")[0], mesh), leaves[0].to_local().device)
    acc0.requires_grad_()
    with spans.span("plan.forward"):
        lv, tok, tap, aux = acc_loss(params, acc0, batch)
    if plan.token_weighted:
        if tok is None:
            raise ValueError(
                "per-token reweighting needs the per-token loss map: the "
                "loss function never called tap.token_loss(...) on its "
                "(B, S) token losses")
        if tuple(tok.shape[:2]) != (lv.shape[0], layout.seq):
            raise ValueError(
                f"the registered per-token loss map has shape "
                f"{tuple(tok.shape)}, which does not lead with (B, S)="
                f"({lv.shape[0]}, {layout.seq}) of the TokenLayout "
                f"accumulator")
    ones = torch.ones_like(lv)

    grads = None
    with spans.span("plan.backward.norms"):
        if plan.needs_grads and not plan.weighted and loss_weights is None:
            # norms and gradients fold into ONE backward (paper §4/§5)
            tap.set_mode(norms=True, grads=True)
            *gs, sq = _grad(lv, leaves + [acc0],
                            mark_seed(ones, kind="plain"))
            grads = unflatten(gs)
        else:
            # norms-only backward: no dW
            tap.set_mode(norms=True, grads=False)
            (sq,) = _grad(lv, [acc0], mark_seed(ones, kind="norms"),
                          retain_graph=plan.needs_grads)
        if mesh is not None:
            sq = _sh.reduce_acc(sq)   # summed over the model axes, whole

    w, tw, cc = _compose_weights(plan, sq, loss_weights)
    if plan.needs_grads and grads is None:
        # reweighted backward: no stats, no norm kernels
        tap.set_mode(norms=False, grads=True)
        if tw is not None:
            # token-weighted: the (B, S) map alone is seeded (loss_vec's
            # seed is zero)
            tok_seed = tw if w is None else tw * w[:, None]
            out, seed = tok, mark_seed(seed_as(tok, tok_seed.to(tok.dtype)),
                                       kind="weighted")
        else:
            out = lv
            seed = mark_seed(ones, kind="plain") if w is None \
                else mark_seed(seed_as(lv, w.to(lv.dtype)), kind="weighted")
        with spans.span("plan.backward.grads"):
            grads = unflatten(_grad(out, leaves, seed))
    return lv.detach(), aux, sq, grads, w, tw, cc


def _compose_weights(plan: Plan, sq_norms, loss_weights,
                     extra_weights=None):
    """Product of clip coefficients × importance weights
    (``extra_weights``) × user loss weights. Returns (per-example w | None,
    token w | None, clip_coef | None)."""
    w = loss_weights
    if extra_weights is not None:
        w = extra_weights if w is None else w * extra_weights
    cc = tw = None
    if plan.clip is not None:
        if plan.clip.granularity == "token":
            cc = tw = token_clip_coefficients(sq_norms, plan.clip.clip_norm,
                                              plan.clip.eps)
        else:
            cc = clip_coefficients(sq_norms, plan.clip.clip_norm,
                                   plan.clip.eps)
            w = cc if w is None else w * cc
    return w, tw, cc


# ---------------------------------------------------------------------------
# execute: the importance split, noise, GNS
# ---------------------------------------------------------------------------

#: a fused_fn: (sub-plan, batch, batch_size, loss_weights) -> the
#: run_fused tuple. ``execute`` defaults to the local one; dist.pex passes
#: one that runs each rank's rows and returns global arrays, so the same
#: driver serves the mesh.
FusedFn = Callable[[Plan, Any, int, Optional[torch.Tensor]], Tuple]

_NORMS_ONLY = Plan(needs_norms=True)
_GRADS_ONLY = Plan(needs_grads=True)


def execute(plan: Plan, acc_loss: Callable, params, batch,
            batch_size: int, layout, *, loss_weights=None,
            fused_fn: Optional[FusedFn] = None) -> StepResult:
    """Run a full plan: the fused region(s), then noise and GNS."""
    if fused_fn is None:
        def fused_fn(sub, b, bs, lw):
            return run_fused(sub, acc_loss, params, b, bs, layout,
                             loss_weights=lw)

    samp = sub_sq = None
    if plan.importance is None:
        lv, aux, sq, grads, w, tw, cc = fused_fn(plan, batch, batch_size,
                                                 loss_weights)
    else:
        ip = plan.importance
        lv, aux, sq, _, _, _, _ = fused_fn(_NORMS_ONLY, batch, batch_size,
                                           None)
        samp = imp.sample(ip.rng, sq, ip.k, smoothing=ip.smoothing,
                          replace=ip.replace)
        sub_batch = imp.gather_batch(batch, samp.indices,
                                     batch_size=batch_size)
        sub_sq = sq.index_select(0, samp.indices)
        w, tw, cc = _compose_weights(
            plan, sub_sq,
            None if loss_weights is None
            else loss_weights.index_select(0, samp.indices),
            extra_weights=samp.weights)
        grads = None
        if plan.needs_grads:
            _, _, _, grads, w, _, _ = fused_fn(_GRADS_ONLY, sub_batch,
                                               ip.k, w)

    gns = None
    if plan.gns:
        gns = gradient_noise_scale(
            sq if sub_sq is None else sub_sq, grads,
            batch_size=batch_size if samp is None else plan.importance.k,
            weights=w)
    if grads is not None:
        # the plan/apply boundary (identity markers; a trace reads them)
        grads = mark_grad_tree(grads)
    if plan.noise is not None and grads is not None:
        scale = plan.noise.scale if plan.noise.scale is not None \
            else plan.clip.clip_norm
        with spans.span("plan.noise"):
            if plan.noise.segments is not None:
                grads = add_grad_noise_segmented(
                    grads, plan.noise.noise_std, scale, plan.noise.rng,
                    plan.noise.segments)
            else:
                grads = add_grad_noise(grads, plan.noise.noise_std, scale,
                                       plan.noise.rng)
    return StepResult(torch.sum(lv), lv, aux, sq, grads, w, tw, cc, gns,
                      samp, sub_sq)


# ---------------------------------------------------------------------------
# GNS — a thin consumer over quantities the plan already has
# ---------------------------------------------------------------------------

def gradient_noise_scale(sq_norms: torch.Tensor, grads,
                         batch_size: Optional[int] = None,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Critical-batch diagnostic B_simple = tr(Σ) / ‖G‖² from the
    per-example squared norms (Gray et al. 2024 / McCandlish et al. 2018).
    ``grads`` is the *summed* gradient tree; ``weights`` (per-example
    reweighting active in the plan) scales the norms by w²."""
    if sq_norms.ndim == 2:
        sq_norms = torch.sum(sq_norms, dim=-1)
    if weights is not None:
        sq_norms = sq_norms * torch.square(weights.to(torch.float32))
    b = batch_size if batch_size is not None else sq_norms.shape[0]
    if b < 2:
        raise ValueError(f"gradient_noise_scale needs batch >= 2 to "
                         f"separate the two moments (got {b})")
    s_bar = torch.mean(sq_norms.to(torch.float32))
    g_sq = sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in tree_flatten(grads)[0])
    g_mean_sq = g_sq / (b * b)
    tr_sigma = (s_bar - g_mean_sq) * b / (b - 1)
    norm_g_sq = (b * g_mean_sq - s_bar) / (b - 1)
    return tr_sigma / torch.clamp(norm_g_sq, min=1e-20)
