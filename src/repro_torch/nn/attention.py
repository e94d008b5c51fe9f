"""Grouped-query attention: the unfused path and the flash route.

Port of ``src/repro/nn/attention.py`` for the GQA family at training time:
RoPE (partial with ``rope_dim``) or M-RoPE (``mrope_sections``), optional
QKV bias, gemma2's attention-logit softcap and sliding window (applied on
the layers whose ``local_flag`` is set), Q-head padding to
``head_multiple`` (padded heads get zero in/out projections, so logits,
gradients and per-example stats are exact), cross-attention (``cross``:
k and v from the encoder's ``memory``, no RoPE, no mask), ``causal=False``
(seamless's encoder) and ``d_out`` (zamba2's shared block maps 2·d_model
back to d_model). ``AttnCfg.flash`` (default False, as in the reference)
sends the attention core through the flash kernels
(``kernels.ops.flash_attention_vjp``) under the reference's own gate;
otherwise the unfused ``_attend`` runs.

Serving: ``init_kv_cache`` makes a (B, max_len, n_kv, head_dim) K and V
buffer, and ``attention(cache=, cache_index=)`` writes the new rows into it
in place and attends over the rows written so far; a cross-attention
layer takes its encoder K and V precomputed in ``cache``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.taps import Tap
from repro_torch.kernels import ops
from repro_torch.dist.sharding import is_dtensor, on_heads, pad_to, shard
from repro_torch.nn import param as pm
from repro_torch.nn.linear import init_linear, linear
from repro_torch.nn.rotary import apply_rope, mrope_angles, rope_angles

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    bias: bool = False                 # qwen2-style QKV bias
    softcap: Optional[float] = None    # gemma2 attn logit softcap
    window: Optional[int] = None       # sliding-window size (None = global)
    rope_theta: float = 10000.0
    rope_dim: Optional[int] = None     # partial rotary (None = full head_dim)
    mrope_sections: Optional[Tuple[int, ...]] = None
    attn_scale: Optional[float] = None # None → head_dim ** -0.5
    head_multiple: int = 16            # pad n_heads up to this multiple
    cross: bool = False                # cross-attention (kv from memory)
    causal: bool = True
    d_out: Optional[int] = None        # output dim if != d_model (zamba2)
    flash: bool = False                # flash kernels for the full-seq
                                       # causal path (see ``attention``)

    @property
    def n_heads_p(self) -> int:
        return pad_to(self.n_heads, self.head_multiple)

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None \
            else self.head_dim ** -0.5


def init_attention(gen: torch.Generator, cfg: AttnCfg, *, dtype, device):
    hq = cfg.n_heads_p * cfg.head_dim
    hkv = cfg.n_kv * cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": init_linear(gen, cfg.d_model, hq, bias=cfg.bias,
                          axes=("embed", "heads"), **kw),
        "wk": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias,
                          axes=("embed", "kv_heads"), **kw),
        "wv": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias,
                          axes=("embed", "kv_heads"), **kw),
        "wo": init_linear(gen, hq, cfg.d_out or cfg.d_model, bias=False,
                          axes=("heads", "embed"), **kw),
    }
    hreal = cfg.n_heads * cfg.head_dim
    p["wq"]["w"][:, hreal:] = 0     # padded heads → exact
    p["wo"]["w"][hreal:, :] = 0
    return p


def init_kv_cache(batch: int, max_len: int, cfg: AttnCfg, *, dtype,
                  device):
    """Zero K and V buffers (B, max_len, n_kv, head_dim) of one layer."""
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attend(q, k, v, cfg: AttnCfg, local_flag: Optional[bool] = None, *,
            q_offset: int = 0, kv_len: Optional[int] = None):
    """q (B,S,Hp,D), k/v (B,T,Hkv,D) → (B, S, Hp·D); logits (then the
    softcap) and softmax in f32. q[:, i] sits at absolute position
    ``q_offset + i`` and k[:, t] at t. The causal mask applies when
    ``cfg.causal and not cfg.cross``; ``cfg.window`` applies where
    ``local_flag`` is None or True (gemma2's local layers), not where it is
    False (its global ones); with ``kv_len`` (a cache's valid rows) only
    rows t < kv_len are seen."""
    if is_dtensor(q):
        # on each rank's examples and heads (dist.sharding.on_heads)
        return on_heads(lambda q, k, v: _attend(
            q, k, v, cfg, local_flag, q_offset=q_offset, kv_len=kv_len),
            q, k, v)
    b, s, hp, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hp // hkv
    qg = q.reshape(b, s, hkv, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32)) * cfg.scale
    if cfg.softcap is not None:
        logits = cfg.softcap * torch.tanh(logits / cfg.softcap)
    qpos = q_offset + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if cfg.causal and not cfg.cross:
        mask = mask & (kpos <= qpos)
    if cfg.window is not None and local_flag is not False:
        mask = mask & ((qpos - kpos) < cfg.window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    logits = torch.where(mask, logits,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", attn, v)
    return out.reshape(b, s, hp * d)


def attention(p, x, *, tap: Tap, cfg: AttnCfg,
              positions: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None,
              cache=None, cache_index=None,
              local_flag: Optional[bool] = None,
              group: str = "attn") -> torch.Tensor:
    """Full-sequence (train/prefill) or incremental (decode) attention.
    positions: (S,) / (B,S) int, or (3,B,S) for M-RoPE (a 2-D stream is
    broadcast to all three sections, the text-only fallback); by default
    ``cache_index + arange(S)`` (0 without a cache). ``memory`` (B, T,
    d_model): the encoder output that k and v project from under
    ``cfg.cross`` (no RoPE then, and no mask). ``local_flag``: gemma2's
    per-layer switch of the window (see ``_attend``), a Python bool.

    ``cache`` (``init_kv_cache``) with ``cache_index`` (an int): the new k
    and v rows are written into the cache in place at [cache_index,
    cache_index + S), and q attends over the rows [0, cache_index + S) at
    positions from cache_index on. The reference attends over the whole
    buffer with rows at or past cache_index + S masked; a masked logit of
    ``NEG_INF`` gets exactly zero weight after the softmax's max
    subtraction, so attending over the written prefix alone is the same
    function. Under ``cfg.cross`` a ``cache`` holds the encoder's k and v
    (``seamless.precompute_cross``) and ``memory`` is not projected.

    With ``cfg.flash`` the core runs through the flash kernels on (B, H,
    S, D) views of q, k and v (no copy, ``cfg.window`` passed on) under the
    reference's gate (``attention.py:182-184``): causal self-attention, no
    softcap, no local flag, no cache and S a multiple of 128. Otherwise
    ``_attend`` runs. The gate is the reference's dispatch, kept so that
    one configuration takes one route in both packages; the kernels
    themselves take a softcap, a window and any S, so it is not a
    fallback."""
    cross_cache = cfg.cross and cache is not None
    if cfg.cross and memory is None and not cross_cache:
        raise ValueError("cross-attention needs the encoder's memory")
    if cache is not None and not cfg.cross and cache_index is None:
        raise ValueError("a self-attention cache needs its cache_index")
    b, s, _ = x.shape
    q = linear(p["wq"], x, tap=tap, group=group)
    # each projection is constrained before its heads are split off: the
    # heads of a shard must be whole (a DTensor cannot split a dim whose
    # shards would cut a head)
    q = shard(q, "batch", None, "heads_act").reshape(
        b, s, cfg.n_heads_p, cfg.head_dim)
    if cross_cache:
        k, v = cache["k"], cache["v"]
    else:
        kv_src = memory if cfg.cross else x
        t = kv_src.shape[1]
        k = linear(p["wk"], kv_src, tap=tap, group=group)
        v = linear(p["wv"], kv_src, tap=tap, group=group)
        k = shard(k, "batch", None, "kv_heads_act").reshape(
            b, t, cfg.n_kv, cfg.head_dim)
        v = shard(v, "batch", None, "kv_heads_act").reshape(
            b, t, cfg.n_kv, cfg.head_dim)
    if not cfg.cross:
        if positions is None:
            start = 0 if cache_index is None else cache_index
            positions = (start + torch.arange(s, device=x.device))[None] \
                .expand(b, s)
        rot = cfg.rope_dim or cfg.head_dim
        if cfg.mrope_sections is not None:
            if positions.ndim == 2:   # text-only fallback: t=h=w stream
                positions = positions.expand(3, *positions.shape)
            ang = mrope_angles(positions, rot, cfg.rope_theta,
                               cfg.mrope_sections)
        else:
            if positions.ndim == 1:
                positions = positions[None]
            ang = rope_angles(positions, rot, cfg.rope_theta)
        q = apply_rope(q, ang, cfg.rope_dim)
        k = apply_rope(k, ang, cfg.rope_dim)
    kv_len, q_offset = None, 0
    if cache is not None and not cfg.cross:
        kv_len, q_offset = cache_index + s, cache_index
        cache["k"][:, cache_index:kv_len] = k
        cache["v"][:, cache_index:kv_len] = v
        k, v = cache["k"][:, :kv_len], cache["v"][:, :kv_len]
    if (cfg.flash and cache is None and cfg.causal and not cfg.cross
            and cfg.softcap is None and local_flag is None
            and s % 128 == 0):
        def flash(q, k, v):
            y = ops.flash_attention_vjp(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), cfg.scale,
                                        cfg.window)
            return y.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)
        # DTensor operands: the kernels on each rank's examples and heads
        y = on_heads(flash, q, k, v)
    else:
        y = _attend(q, k, v, cfg, local_flag, q_offset=q_offset,
                    kv_len=kv_len)
    return shard(linear(p["wo"], y, tap=tap, group=group),
                 "batch", None, "embed_act")
