"""The reference's training steps, in float32, one example at a time.

Each step: every example's loss and its own gradient by a backward pass of
its own; its squared norm (summed in float64); with clipping its weight
min(1, C / (‖g_j‖ + 1e-6)); the gradient Σ_j w_j g_j. With noise, σ·C
times a standard normal sample is added to each leaf, drawn leaf by leaf
in the tree's sorted-key order, each as one float32 ``torch.randn`` of the
leaf's shape from the generator the benchmark hands to both sides. Then
AdamW (decoupled weight decay) on the gradient scaled by
min(1, clip / (‖G‖ + 1e-9)).

Readings, the quantities the comparison holds the program's against:
``loss`` each step's Σ_j loss_j; ``sq_norms`` each step's (B,) squared
norms; ``grad_clean`` each leaf's norm of the first step's gradient before
the noise (which leaves the comparison counts); ``grad_seen`` each leaf's
norm of the first gradient as the optimizer takes it (noised, scaled);
``update`` each leaf's norm of the parameters' change over the steps
followed, taken by the caller against the starting weights.

The model is a family's reference module (``perfbench/reference/
<family>.py``): its ``example_loss``, ``route_batch`` and ``_mm``. The
traffic's mode picks the weights: ``plain`` and ``norms`` weigh every
example 1, ``clip`` by its clip factor; any other mode, and any
granularity but ``example``, is refused.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

#: the modes this step follows
MODES = ("plain", "norms", "clip")


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves(x, prefix + (i,))
    else:
        yield tree


def follow(model, params, c: dict, traffic: dict, batches: List, *,
           noise_gen: Optional[torch.Generator] = None, mm=None,
           alter: Optional[Callable] = None,
           reweight: Optional[Callable] = None,
           routes: Optional[List] = None) -> dict:
    """Run ``len(batches)`` steps of ``model`` from ``params`` (float32,
    changed in place); ``batches`` are (ids, labels) int64 tensors (B, S)
    on the parameters' device. ``alter(ids, labels) -> (ids, labels,
    scales)`` plants a fault in each step's batch and per-example loss
    scales, ``reweight(j, B, w) -> w'`` one in example j's weight in the
    summed gradient, its norm left sound (the faults' readings).
    ``routes[step][l]`` (B, S, k): the experts each
    MoE block chose in the program's place, which the reference follows
    (a top-k choice flips between precisions where two probabilities
    nearly tie); the reading ``route_gap`` says how far those choices fall
    short of the reference's own top k."""
    if traffic["mode"] not in MODES \
            or traffic.get("granularity", "example") != "example":
        raise ValueError(f"the reference follows the modes {MODES} at "
                         f"example granularity, not {traffic['mode']!r} "
                         f"at {traffic.get('granularity')!r}")
    mm = mm or model._mm
    ps = list(leaves(params))
    for p in ps:
        p.requires_grad_(True)
    opt = traffic["adamw"]
    clip = traffic.get("clip_norm") if traffic["mode"] == "clip" else None
    sigma = traffic.get("noise_std", 0.0) if clip is not None else 0.0
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    out = {"loss": [], "sq_norms": [], "routes": [], "route_gap": 0.0}
    for step, (ids, labels) in enumerate(batches, start=1):
        scales = [1.0] * ids.shape[0]
        if alter is not None:
            ids, labels, scales = alter(ids, labels)
        ex_routes, chosen, gap = model.route_batch(
            params, ids, c, mm, None if routes is None else routes[step - 1])
        out["routes"].append(chosen)
        out["route_gap"] = max(out["route_gap"], gap)
        total = [torch.zeros_like(p) for p in ps]
        losses, sq = [], []
        for j in range(ids.shape[0]):
            loss = scales[j] * model.example_loss(
                params, ids[j], labels[j], c, mm,
                None if ex_routes is None else ex_routes[j])
            grads = torch.autograd.grad(loss, ps)
            s = sum(torch.sum(torch.square(g.double())) for g in grads)
            w = 1.0
            if clip is not None:
                w = min(1.0, clip / (float(torch.sqrt(s)) + 1e-6))
            if reweight is not None:
                w = reweight(j, ids.shape[0], w)
            for acc, g in zip(total, grads):
                acc.add_(g, alpha=w)
            losses.append(float(loss.detach()))
            sq.append(float(s))
            del grads, loss
        out["loss"].append(sum(losses))
        out["sq_norms"].append(sq)
        with torch.no_grad():
            if step == 1:
                out["grad_clean"] = [float(torch.linalg.vector_norm(g))
                                     for g in total]
            if sigma:
                for g in total:
                    g.add_(torch.randn(g.shape, generator=noise_gen,
                                       device=g.device, dtype=torch.float32),
                           alpha=sigma * clip)
            gn = float(torch.sqrt(sum(torch.sum(torch.square(g.double()))
                                      for g in total)))
            scale = 1.0
            if opt.get("global_clip") is not None:
                scale = min(1.0, opt["global_clip"] / (gn + 1e-9))
            if step == 1:
                out["grad_seen"] = [scale * float(torch.linalg.vector_norm(g))
                                    for g in total]
            b1c = 1.0 - opt["b1"] ** step
            b2c = 1.0 - opt["b2"] ** step
            for p, g, m, v in zip(ps, total, mu, nu):
                g.mul_(scale)
                m.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                delta = (m / b1c) / (torch.sqrt(v / b2c) + opt["eps"]) \
                    + opt["weight_decay"] * p
                p.sub_(opt["lr"] * delta)
            del total
    for p in ps:
        p.requires_grad_(False)
    return out
