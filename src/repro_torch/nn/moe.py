"""Mixture-of-Experts with capacity-based dispatch (GShard-style).

Port of ``src/repro/nn/moe.py``. Token→expert routing is computed with a
sort (no (T·K, E) one-hot): a stable argsort by expert id gives each token
its slot rank inside its expert; rows past the static capacity drop out.
Dispatch and combine are batched gathers over the group axis. Per-example
gradient norms stay exact through the shuffle: every capacity slot carries
its group-local example id, and the expert matmuls go through the expert
taps (``tap.dense_expert_grouped``), whose stats are segmented-direct over
(group, expert, example) segments; every slot also carries its group-local
flat token id (``tok``, from the same dispatch sort), which the token
layout's expert taps scatter their per-slot stats through.

Covers phi3.5-moe (16 experts, top-2, renormalized gates) and the routed
part of deepseek-v2 (with ``n_shared`` shared experts as one MLP).

Sharded (DTensor) activations: the routing and the dispatch and combine
index arithmetic (sorts, searchsorted, gathers, which DTensor has no
sharding rules for) run on plain tensors. Where the ``moe_groups`` mesh
axes (the data axes) divide the dispatch groups, each data rank routes
its own rows into its own groups, as the reference's GShard-local groups
do; otherwise every rank routes the whole batch. The capacity buffer is
then laid out by the reference's constraint ``("moe_groups", "experts",
"capacity", None)``, so each rank runs the expert matmuls and their stats
on its own experts; the expert outputs are gathered over the model axis
for the combine, and the result is laid out as ``("batch", None,
"embed_act")``.
``load_balance_loss`` is ported, and, as in the reference, no loss calls
it: it couples examples.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.core.taps import Tap, recomputing
from repro_torch.dist import sharding as _sh
from repro_torch.nn import param as pm
from repro_torch.nn.linear import init_linear, linear
from repro_torch.nn.mlp import MlpCfg, _act, init_mlp, mlp


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared experts (merged into one MLP)
    capacity_factor: float = 1.25
    act: str = "silu"
    renorm_topk: bool = False    # phi/mixtral renormalize selected gates
    routed_scale: float = 1.0    # deepseek routed_scaling_factor
    # grouped local dispatch: each group of examples scatters its own
    # tokens into its own capacity slice. 1 = one group of the whole batch.
    dispatch_groups: int = 1

    def capacity(self, n_tokens: int) -> int:
        c = int(self.capacity_factor * n_tokens * self.top_k
                / self.n_experts) + 1
        return max(8, ((c + 7) // 8) * 8)


def init_moe(gen: torch.Generator, cfg: MoeCfg, *, dtype, device):
    """Router in f32 (std 0.02); stacked (E, d, f) gate/up and (E, f, d)
    down expert weights with fan-in std."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": init_linear(gen, d, e, dtype=torch.float32, device=device,
                              axes=("embed", None), std=0.02),
        # the expert axis over the model axis; the inner dims take axes of
        # their own, so that they never map the model axis twice
        "gate": pm.normal(gen, (e, d, f), dtype, device, std=d ** -0.5,
                          axes=("experts", "embed", "expert_ff")),
        "up": pm.normal(gen, (e, d, f), dtype, device, std=d ** -0.5,
                        axes=("experts", "embed", "expert_ff")),
        "down": pm.normal(gen, (e, f, d), dtype, device, std=f ** -0.5,
                          axes=("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, MlpCfg(d, cfg.n_shared * f, act=cfg.act),
                               dtype=dtype, device=device)
    return p


def _route(cfg: MoeCfg, logits: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) → (gates (T,K), expert idx (T,K))."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.renorm_topk:
        gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates * cfg.routed_scale, idx


def moe(p, x, *, tap: Tap, cfg: MoeCfg, group: str = "moe",
        example_ids: Optional[torch.Tensor] = None):
    """x: (B, S, d). example_ids: (B,) int (defaults to arange(B))."""
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    ng = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 and \
        b % cfg.dispatch_groups == 0 else 1
    tg = t // ng
    cap = cfg.capacity(tg)

    # router tap sees (B, S, ·) so its per-example stats stay exact
    logits = linear(p["router"], x.to(torch.float32), tap=tap, group=group)
    mesh = x.device_mesh if _sh.is_dtensor(x) else None
    x_in, lay = x, None
    if mesh is not None:
        # routing and dispatch on plain tensors: each data rank's own
        # groups where the data axes divide the groups, else all of them
        lay = _group_layout(mesh, ng)
        logits = logits.redistribute(mesh, lay).to_local()
        x_in = x.redistribute(mesh, lay).to_local()
    b_l, ng_l = x_in.shape[0], ng * x_in.shape[0] // b
    t_l = b_l * s
    dev = x_in.device
    gates, eidx = _route(cfg, logits.reshape(t_l, -1))      # (T,K)

    if example_ids is None:
        example_ids = torch.arange(b_l, device=dev)
    bg = b // ng                                            # examples/group
    tok_example = torch.repeat_interleave(example_ids, s)   # (T,)
    rel_example = (tok_example % bg).reshape(ng_l, tg)      # group-local ids

    # --- slot assignment via per-group sort --------------------------------
    e_dim = cfg.n_experts
    flat_e = eidx.reshape(ng_l, tg * k)
    flat_tok = torch.arange(tg, device=dev).repeat_interleave(k) \
        .expand(ng_l, tg * k)
    flat_gate = gates.reshape(ng_l, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e_dim + 1, device=dev).expand(ng_l, e_dim + 1)
        .contiguous())                                       # (G, E+1)
    pos = torch.arange(tg * k, device=dev) - torch.gather(starts, 1, sorted_e)
    src_tok = torch.gather(flat_tok, 1, order)               # (G, Tg·K)

    # slot (e, c) ← token: sorted position starts[e]+c, valid if c < count_e
    c_iota = torch.arange(cap, device=dev)
    sorted_pos = starts[:, :-1, None] + c_iota               # (G, E, cap)
    count = (starts[:, 1:] - starts[:, :-1])[..., None]      # (G, E, 1)
    slot_valid = c_iota < torch.clamp(count, max=cap)
    if spans.active() and not recomputing():
        # how full the slots the expert products run over are, and how
        # many assignments capacity drops (once per forward)
        spans.count("moe.slots", ng_l * e_dim * cap)
        spans.count("moe.filled", torch.clamp(count, max=cap).sum())
        spans.count("moe.assignments", t_l * k)
    sorted_pos = torch.clamp(sorted_pos, max=tg * k - 1) \
        .reshape(ng_l, e_dim * cap)
    tok_for_slot = torch.gather(src_tok, 1, sorted_pos)
    tok_for_slot = torch.where(slot_valid.reshape(ng_l, e_dim * cap),
                               tok_for_slot, tg)             # tg ⇒ pad row

    # --- dispatch: batched gather from zero-padded local tokens -------------
    gi = torch.arange(ng_l, device=dev)[:, None]
    xg_pad = torch.cat([x_in.reshape(ng_l, tg, d),
                        torch.zeros((ng_l, 1, d), dtype=x.dtype,
                                    device=dev)], dim=1)
    buf = xg_pad[gi, tok_for_slot].reshape(ng_l, e_dim, cap, d)
    rel_pad = torch.cat([rel_example,
                         torch.full((ng_l, 1), bg, device=dev,
                                    dtype=rel_example.dtype)], dim=1)
    seg = torch.gather(rel_pad, 1, tok_for_slot).reshape(ng_l, e_dim, cap)
    # the dispatch sort already knows each slot's source token: carry it so
    # TokenLayout taps can scatter slot stats back to (B, S) positions
    # (tg ⇒ padding slot; group g covers flat tokens [g·tg, (g+1)·tg))
    tok = tok_for_slot.reshape(ng_l, e_dim, cap)
    if mesh is not None:
        buf, seg, tok = (_groups(v, mesh, lay, ng) for v in (buf, seg, tok))
        groups = "moe_groups" if ng_l < ng else None
        buf = _sh.shard(buf, groups, "experts", "capacity", None)

    # --- expert MLP (tapped; stats via group-local segmented-direct) --------
    g = tap.dense_expert_grouped(buf, p["gate"], seg, bg, tok, group=group)
    u = tap.dense_expert_grouped(buf, p["up"], seg, bg, tok, group=group)
    h = (_act(cfg.act)(g) * u).to(x.dtype)
    y_buf = tap.dense_expert_grouped(h, p["down"], seg, bg, tok, group=group)
    if mesh is not None:
        y_buf = _sh.shard(y_buf, groups, "experts", "capacity", None)
        y_buf = y_buf.redistribute(mesh, lay).to_local()

    # --- combine: batched gather back (dropped slots → zero pad row) --------
    slot_sorted = torch.where(pos < cap, sorted_e * cap + pos, e_dim * cap)
    inv = torch.argsort(order, dim=1)
    slot_orig = torch.gather(slot_sorted, 1, inv)            # (G, Tg·K)
    y_flat = torch.cat([y_buf.reshape(ng_l, e_dim * cap, d),
                        torch.zeros((ng_l, 1, d), dtype=y_buf.dtype,
                                    device=dev)], dim=1)
    slot_y = y_flat[gi, slot_orig]
    contrib = slot_y * flat_gate[..., None].to(x.dtype)
    y = torch.sum(contrib.reshape(t_l, k, d), dim=1).reshape(b_l, s, d)
    if mesh is not None:
        y = _sh.shard(_groups(y, mesh, lay, b), "batch", None, "embed_act")

    if cfg.n_shared:
        y = y + mlp(p["shared"], x, tap=tap,
                    cfg=MlpCfg(d, cfg.n_shared * cfg.d_ff, act=cfg.act),
                    group=group)
    return y


def _group_layout(mesh, ng: int):
    """Placements of the dispatch's plain tensors on ``mesh``: rows over
    the mesh axes of ``moe_groups`` where their extent divides the ``ng``
    groups (each data rank dispatches its own groups), replicated
    otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    axes = _sh.spec("moe_groups")[0]
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    if ng % _sh.axis_size(axes, mesh):
        axes = ()
    return [Shard(0) if n in axes else Replicate()
            for n in mesh.mesh_dim_names]


def _groups(v: torch.Tensor, mesh, lay, lead: int):
    """This rank's plain piece ``v`` of a tensor whose leading extent is
    ``lead``, as a DTensor laid out as ``lay`` (differentiable: its
    gradient comes back as the rank's piece)."""
    from torch.distributed.tensor import DTensor
    shape = (lead,) + tuple(v.shape[1:])
    return DTensor.from_local(v, mesh, lay, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def load_balance_loss(cfg: MoeCfg, logits: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss over router ``logits`` (..., E): E · Σ_e f_e ·
    p̄_e, with f the share of top-k picks and p̄ the mean router
    probability along the leading axis. Batch-coupled, so off by default
    when exact per-example norms are required (DESIGN.md §5)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    _, idx = torch.topk(probs, cfg.top_k, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, cfg.n_experts).sum(dim=-2)
    f = torch.mean(onehot.to(torch.float32), dim=0)
    p_mean = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(f * p_mean)
