"""Plain float32 forward of the decoder-only transformer, one example at a
time, from a configuration file's published sizes.

Per block: RMSNorm (gain g, eps from the file), grouped-query attention
(q/k/v with the file's bias switch, RoPE on the whole head, half-split,
angles in float64; causal softmax in float32; query head h reads key/value
head h // (heads / kv heads)), the output projection, a residual; RMSNorm,
then a SwiGLU MLP, down(silu(x·gate) ⊙ x·up), or the MoE layer below, a
residual. A final RMSNorm, the LM head, and the example's loss is the sum
over its tokens of the cross-entropy against its labels.

MoE: the router's float32 logits, softmax, the top k experts with their
probabilities renormalized to sum to one (÷ (Σ + 1e-9)), each expert a
SwiGLU of its own weights, the output Σ_k gate_k · expert_k(x). A token's
slot at an expert is kept while the expert has capacity in the token's
dispatch group: groups of ``dispatch_groups`` examples' tokens where that
divides the batch, else one group of the whole batch; capacity
max(8, ⌈(int(cf · T · k / E) + 1) / 8⌉ · 8) for T tokens in a group; slots
are taken in token order, then in rank order within a token. Dropping
couples the examples of a group, so :func:`route_batch` decides every
token's experts and kept slots for the whole batch first (no gradient:
the choice is discrete), and :func:`example_loss` follows them.

Every matrix product of a linear layer or an expert goes through
``mm(a, b)``: ``torch.matmul`` here, a lower-precision product in the
control (``reference.lowp``). The parameters are a nested dict of float32
tensors laid out as the benchmark's schema names them.

``follow`` is the family's training step (``reference.train.follow`` over
this model), which the harness finds by the family's name.
"""
from __future__ import annotations

import math
import sys
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import train


def _mm(a, b):
    return torch.matmul(a, b)


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def linear(p, x, mm):
    y = mm(x, p["w"])
    return y + p["b"] if "b" in p else y


def rope(x, theta: float):
    """x (S, H, D): rotate every pair (i, i + D/2) of each head by
    position · θ^(−2i/D)."""
    s, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, c: dict, mm):
    s = x.shape[0]
    hq, hkv, d = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    q = rope(linear(p["wq"], x, mm).reshape(s, hq, d), c["rope_theta"])
    k = rope(linear(p["wk"], x, mm).reshape(s, hkv, d), c["rope_theta"])
    v = linear(p["wv"], x, mm).reshape(s, hkv, d)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("shd,thd->hst", q, k) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hst,thd->shd", torch.softmax(logits, dim=-1), v)
    return linear(p["wo"], out.reshape(s, hq * d), mm)


def swiglu(x, gate, up, down, mm):
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def router_probs(p, x):
    return torch.softmax(torch.matmul(x, p["router"]["w"]), dim=-1)


def moe(p, x, route: Tuple[torch.Tensor, torch.Tensor], c: dict, mm):
    """x (S, d); route: the example's expert ids (S, k) and kept slots
    (S, k) from :func:`route_batch`."""
    idx, keep = route
    probs = router_probs(p, x)
    gates = torch.gather(probs, 1, idx)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(x)
    for e in range(c["num_local_experts"]):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], p["gate"][e], p["up"][e], p["down"][e], mm)
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    return y


def capacity(c: dict, n_tokens: int) -> int:
    run = c["run"]
    cap = int(run["capacity_factor"] * n_tokens * c["num_experts_per_tok"]
              / c["num_local_experts"]) + 1
    return max(8, ((cap + 7) // 8) * 8)


def keep_slots(c: dict, idx: torch.Tensor) -> torch.Tensor:
    """idx (B, S, k) expert ids → kept slots (B, S, k) under each dispatch
    group's capacity."""
    b, s, k = idx.shape
    ng = c["run"]["dispatch_groups"]
    if (b * s) % ng or b % ng:
        ng = 1
    flat = idx.reshape(ng, (b // ng) * s * k)
    cap = capacity(c, (b // ng) * s)
    onehot = F.one_hot(flat, c["num_local_experts"])
    rank = torch.gather(torch.cumsum(onehot, dim=1), 2, flat[..., None])
    return (rank[..., 0] <= cap).reshape(b, s, k)


def _block(p, x, c, mm, route):
    eps = c["rms_norm_eps"]
    x = x + attention(p["attn"], rmsnorm(x, p["ln_attn"]["g"], eps), c, mm)
    h = rmsnorm(x, p["ln_mlp"]["g"], eps)
    if "moe" in p:
        return x + moe(p["moe"], h, route, c, mm)
    m = p["mlp"]
    return x + swiglu(h, m["gate"]["w"], m["up"]["w"], m["down"]["w"], mm)


def example_loss(params, ids, labels, c: dict, mm=_mm,
                 routes: Optional[List] = None):
    """One example's summed token cross-entropy: ids, labels (S,);
    ``routes[l]`` the example's (idx, keep) at block l (MoE)."""
    x = params["embed"]["table"][ids]
    for i, p in enumerate(params["blocks"]):
        x = _block(p, x, c, mm, None if routes is None else routes[i])
    x = rmsnorm(x, params["ln_f"]["g"], c["rms_norm_eps"])
    logits = mm(x, params["head"]["w"])
    return torch.sum(torch.logsumexp(logits, dim=-1)
                     - torch.gather(logits, 1, labels[:, None])[:, 0])


@torch.no_grad()
def route_batch(params, ids, c: dict, mm=_mm, given: Optional[List] = None):
    """Each MoE block's routing for a batch of ids (B, S): ``(routes,
    idx, gap)``, with ``routes[j][l]`` example j's (idx, keep) at block l,
    ``idx[l]`` the (B, S, k) expert ids, and ``gap`` the largest shortfall,
    over tokens, of the probability the chosen experts carry against the
    top k's; ``(None, None, 0.0)`` for a dense model. The forward runs
    block by block over the whole batch (one example's attention at a
    time), since a block's kept slots depend on every example of its
    group. ``given[l]`` (B, S, k) replaces block l's top-k choice: the
    experts that whoever sits in the program's place chose."""
    if not c.get("num_local_experts"):
        return None, None, 0.0
    k = c["num_experts_per_tok"]
    eps = c["rms_norm_eps"]
    xs = [params["embed"]["table"][row] for row in ids]
    per_layer, gap = [], 0.0
    for i, p in enumerate(params["blocks"]):
        xs = [x + attention(p["attn"], rmsnorm(x, p["ln_attn"]["g"], eps),
                            c, mm) for x in xs]
        hs = [rmsnorm(x, p["ln_mlp"]["g"], eps) for x in xs]
        probs = torch.stack([router_probs(p["moe"], h) for h in hs])
        top = torch.topk(probs, k, dim=-1)
        idx = top.indices if given is None else given[i].to(ids.device)
        if given is not None:
            chosen = torch.gather(probs, -1, idx).sum(-1)
            gap = max(gap, float((top.values.sum(-1) - chosen).max()))
        keep = keep_slots(c, idx)
        per_layer.append((idx, keep))
        xs = [x + moe(p["moe"], h, (idx[j], keep[j]), c, mm)
              for j, (x, h) in enumerate(zip(xs, hs))]
    routes = [[(idx[j], keep[j]) for idx, keep in per_layer]
              for j in range(len(xs))]
    return routes, [idx for idx, _ in per_layer], gap


def follow(params, c: dict, traffic: dict, batches: List, **kwargs) -> dict:
    """``reference.train.follow`` of this model."""
    return train.follow(sys.modules[__name__], params, c, traffic, batches,
                        **kwargs)
