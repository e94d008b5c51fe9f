"""``Engine`` — the entry point for per-example-gradient runs.

Port of ``src/repro/core/engine.py``. Every pass takes a
**tap-collector loss**

    loss_fn(params, batch, tap) -> (loss_vec, aux)

(``models.registry.make_loss_fn_v2`` builds one), and ``step`` runs a
consumer list as one fused plan (``core.plan``):

    eng = Engine(PexSpec())
    res = eng.step(loss_fn, params, batch,
                   consumers=[Clip(1.0), Noise(0.5, gen), GNS()])

``granularity="token"`` swaps the accumulator layout to the per-token
(B, S) map (``TokenLayout``) — same taps, same passes, token-level norms;
with a loss that registers its token map (``tap.token_loss``),
``Clip(C, granularity="token")`` reweights every token's loss term by its
own contribution norm in the same fused pass.

The step runs on the device the parameters live on. Parameters that are
DTensors (``dist.sharding.distribute_tree`` under ``use_rules(mesh,
rules)``: the reference's model-axis sharding, ``mesh=None`` here) run the
sharded route of ``core.plan``: each rank computes on its shards, the
norms and losses come back whole, the gradients laid out as their
parameters. ``mesh=`` (a
``DeviceMesh``, ``dist.sharding.make_mesh``) routes every pass through the
data-parallel pipeline ``dist.pex`` over ``data_axes``: each rank runs its
rows of the global batch, gradients are all-reduced, and the results are
global on every rank. ``verify`` runs the trace-only static checks
(``analysis.verify``) against the engine's own spec, mesh and granularity.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import spans
from repro_torch.core import plan as plan_mod
from repro_torch.core.passes import PexResult
from repro_torch.core.plan import StepResult
from repro_torch.core.taps import ExampleLayout, PexSpec, Tap, TokenLayout
from repro_torch.dist import pex as _dpex
from repro_torch.nn.param import resolve_device, tree_leaves


def infer_batch_size(batch) -> int:
    """Leading-axis extent shared by every batch leaf."""
    leaves = tree_leaves(batch)
    if not leaves:
        raise ValueError("cannot infer batch_size from an empty batch tree")
    sizes = {leaf.shape[0] for leaf in leaves}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on the leading (example) "
                         f"axis: {sorted(sizes)}; pass batch_size= explicitly")
    return sizes.pop()


def infer_seq_len(batch) -> int:
    """Second-axis extent of the sequence-shaped batch leaves; must be
    unambiguous (multi-sequence batches need an explicit seq=)."""
    sizes = {leaf.shape[1] for leaf in tree_leaves(batch) if leaf.ndim >= 2}
    if len(sizes) == 1:
        return sizes.pop()
    if not sizes:
        raise ValueError("token granularity needs a (B, S, ...) batch leaf "
                         "to infer the sequence length; pass seq= explicitly")
    raise ValueError(f"batch leaves carry different sequence lengths "
                     f"{sorted(sizes)}; pass seq= explicitly to pick the "
                     f"tapped one")


class Engine:
    """Per-example-gradient engine bound to one instrumentation policy.

    spec:        ``PexSpec`` (default: enabled, method='auto', kernels on).
                 ``taps.DISABLED`` gives a plain engine.
    mesh:        a ``DeviceMesh`` or None. A mesh routes every pass through
                 the ``dist.pex`` data-parallel pipeline over
                 ``data_axes``; None runs on this process alone.
    clip_norm:   default clip threshold C for ``clipped_step``.
    noise_std:   default DP-SGD noise multiplier σ for ``clipped_step``
                 (noise σ·C is added once, after the gradient reduce).
    granularity: 'example' → (B, G) accumulator (per-group columns from
                 ``spec.groups``); 'token' → (B, S) accumulator.
    """

    def __init__(self, spec: Optional[PexSpec] = None, *,
                 mesh=None, data_axes: Sequence[str] = ("data",),
                 clip_norm: Optional[float] = None, noise_std: float = 0.0,
                 granularity: str = "example"):
        if granularity not in ("example", "token"):
            raise ValueError(f"granularity must be 'example' or 'token', "
                             f"got {granularity!r}")
        self.spec = spec if spec is not None else PexSpec()
        self.mesh = mesh
        self.data_axes = (data_axes,) if isinstance(data_axes, str) \
            else tuple(data_axes)
        self.clip_norm = clip_norm
        self.noise_std = noise_std
        self.granularity = granularity

    def _adapt(self, loss_fn: Callable, layout,
               want_token_map: bool = False) -> Callable:
        """Tap-collector loss → the loss the plan layer consumes:
        ``acc_loss(params, acc, batch) -> (loss_vec, token_map | None,
        tap, aux)`` (acc=None ⇒ inert tap ⇒ the plain model); the token
        map is the one the loss registered (``tap.token_loss``), returned
        when ``want_token_map``."""
        def acc_loss(params, acc, batch):
            tap = Tap(self.spec, acc=acc, layout=layout)
            loss_vec, aux = loss_fn(params, batch, tap)
            tok = tap.token_losses() if want_token_map else None
            return loss_vec, tok, tap, aux
        return acc_loss

    def step(self, loss_fn: Callable, params, batch,
             consumers: Sequence = (), *,
             loss_weights: Optional[torch.Tensor] = None,
             batch_size: Optional[int] = None,
             seq: Optional[int] = None) -> StepResult:
        """Run a consumer list as one fused pass. ``consumers`` is any
        subset of ``{Norms(), Grads(), Clip(C, granularity=...),
        Noise(σ, gen), Importance(k, rng=gen), GNS()}``; ``loss_weights``
        is an optional (B,) user weight vector folded into the same
        reweighted backward (with ``Importance``, its sampled rows). With
        ``consumers=()`` the program is the plain forward. ``seq`` is the
        token map's length at token granularity (default: the batch's
        sequence axis)."""
        with spans.span("engine.step"):
            plan = plan_mod.analyze(consumers,
                                    engine_granularity=self.granularity)
            b = batch_size if batch_size is not None \
                else infer_batch_size(batch)
            if plan.token_norms:
                layout = TokenLayout(seq if seq is not None
                                     else infer_seq_len(batch))
            else:
                layout = ExampleLayout(self.spec.n_groups)
            acc_loss = self._adapt(loss_fn, layout,
                                   want_token_map=plan.token_weighted)
            return _dpex.plan_step(plan, acc_loss, params, batch, b,
                                   mesh=self.mesh, data_axes=self.data_axes,
                                   layout=layout, loss_weights=loss_weights)

    # -- fixed-function sugar (one line each over `step`) ---------------
    def value_and_norms(self, loss_fn: Callable, params, batch, *,
                        batch_size: Optional[int] = None,
                        seq: Optional[int] = None) -> PexResult:
        """Norms-only pass (paper §5 cheap pass): no ``dW``."""
        r = self.step(loss_fn, params, batch, [plan_mod.Norms()],
                      batch_size=batch_size, seq=seq)
        return PexResult(r.loss, r.loss_vec, r.aux, r.sq_norms)

    def value_grads_and_norms(self, loss_fn: Callable, params, batch, *,
                              batch_size: Optional[int] = None,
                              seq: Optional[int] = None) -> PexResult:
        """Summed gradients AND all per-example norms in one backward."""
        r = self.step(loss_fn, params, batch,
                      [plan_mod.Norms(), plan_mod.Grads()],
                      batch_size=batch_size, seq=seq)
        return PexResult(r.loss, r.loss_vec, r.aux, r.sq_norms, r.grads)

    def clipped_step(self, loss_fn: Callable, params, batch, *,
                     rng: Optional[torch.Generator] = None,
                     clip_norm: Optional[float] = None,
                     noise_std: Optional[float] = None,
                     batch_size: Optional[int] = None,
                     seq: Optional[int] = None) -> PexResult:
        """Per-example clipping (paper §6 two-pass ghost form), plus
        DP-SGD noise when ``noise_std > 0`` (needs ``rng``). On a
        token-granularity engine this is per-token clipping."""
        c = clip_norm if clip_norm is not None else self.clip_norm
        if c is None:
            raise ValueError("clipped_step needs clip_norm: set it on the "
                             "Engine or pass clip_norm= per call")
        sigma = noise_std if noise_std is not None else self.noise_std
        consumers = [plan_mod.Clip(c, granularity=self.granularity)]
        if sigma and sigma > 0.0:
            # on a token engine, analyze() rejects the defaulted scale
            # (per-token C is not a per-example sensitivity)
            consumers.append(plan_mod.Noise(sigma, rng))
        r = self.step(loss_fn, params, batch, consumers,
                      batch_size=batch_size, seq=seq)
        return PexResult(r.loss, r.loss_vec, r.aux, r.sq_norms, r.grads)

    def gradient_noise_scale(self, loss_fn: Callable, params, batch, *,
                             batch_size: Optional[int] = None
                             ) -> torch.Tensor:
        """Critical-batch diagnostic B_simple = tr(Σ)/||G||² from one
        grads+norms pass."""
        return self.step(loss_fn, params, batch, [plan_mod.GNS()],
                         batch_size=batch_size).gns

    def verify(self, loss_fn: Callable, params, batch,
               consumers: Sequence = (), *, allow: Sequence[str] = (),
               batch_size: Optional[int] = None, seq: Optional[int] = None,
               cfg=None, backend: str = "cuda", production: bool = True,
               deep: bool = True, determinism: bool = True,
               cost: bool = False, optimizer: str = "adamw",
               profile: Optional[str] = None, chips: int = 1,
               model: Optional[str] = None):
        """Static checks of this engine's configuration against a model,
        without running it: tap coverage, the launch contracts of every
        kernel the step would launch on the card, and (``deep``) the
        privacy flow of each consumer set's recorded step, the collective
        layout on this engine's mesh, and the data pipeline's determinism;
        with ``cost``, the traffic and cost of each consumer set's
        recorded training step under ``optimizer`` on the hardware
        ``profile`` for ``chips`` cards (``model`` names the reports).
        ``params`` and ``batch`` may live on any device (``meta`` too);
        they are recorded on ``meta`` copies. Returns an
        ``analysis.VerifyReport``; ``.raise_if_errors()`` for a hard
        gate."""
        from repro_torch.analysis.verify import verify
        return verify(loss_fn, params, batch, consumers, spec=self.spec,
                      granularity=self.granularity, allow=allow,
                      batch_size=batch_size, seq=seq, cfg=cfg,
                      backend=backend, production=production,
                      mesh=self.mesh, data_axes=self.data_axes, deep=deep,
                      determinism=determinism, cost=cost,
                      optimizer=optimizer, profile=profile, chips=chips,
                      model=model)

    def tap(self, batch_size: int, *, seq: Optional[int] = None,
            device=None) -> Tap:
        """Standalone live Tap for hand-rolled transforms (the passes above
        create their own), its accumulator on ``device`` (default CUDA).
        Read ``acc0 = tap.carry()`` before the forward: the gradient of the
        loss w.r.t. ``acc0`` is the (B, G) or (B, S) stat map."""
        if self.granularity == "token" and seq is None:
            raise ValueError("a token-granularity tap needs seq= (the "
                             "length of its (B, S) map)")
        layout = TokenLayout(seq) if self.granularity == "token" \
            else ExampleLayout(self.spec.n_groups)
        acc = layout.init(batch_size, resolve_device(device))
        return Tap(self.spec, acc=acc.requires_grad_(), layout=layout)
