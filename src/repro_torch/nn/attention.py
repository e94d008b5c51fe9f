"""Grouped-query causal self-attention: the unfused path and the flash route.

Port of ``src/repro/nn/attention.py`` for the GQA family at training time:
RoPE, optional QKV bias, Q-head padding to ``head_multiple`` (padded heads
get zero in/out projections, so logits, gradients and per-example stats are
exact). ``AttnCfg.flash`` (default False, as in the reference) sends the
attention core through the flash kernels (``kernels.ops.flash_attention_vjp``)
under the reference's own gate; otherwise the unfused ``_attend`` runs. Not
in this slice: the decode KV cache, cross-attention, M-RoPE, logit softcap
and sliding windows in the model (the flash kernels themselves take both).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.taps import Tap
from repro_torch.kernels import ops
from repro_torch.nn import param as pm
from repro_torch.nn.linear import init_linear, linear
from repro_torch.nn.rotary import apply_rope, rope_angles

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    bias: bool = False                 # qwen2-style QKV bias
    rope_theta: float = 10000.0
    head_multiple: int = 16            # pad n_heads up to this multiple
    flash: bool = False                # flash kernels for the full-seq
                                       # causal path (see ``attention``)

    @property
    def n_heads_p(self) -> int:
        return pm.pad_to(self.n_heads, self.head_multiple)

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5


def init_attention(gen: torch.Generator, cfg: AttnCfg, *, dtype, device):
    hq = cfg.n_heads_p * cfg.head_dim
    hkv = cfg.n_kv * cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": init_linear(gen, cfg.d_model, hq, bias=cfg.bias, **kw),
        "wk": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias, **kw),
        "wv": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias, **kw),
        "wo": init_linear(gen, hq, cfg.d_model, bias=False, **kw),
    }
    hreal = cfg.n_heads * cfg.head_dim
    p["wq"]["w"][:, hreal:] = 0     # padded heads → exact
    p["wo"]["w"][hreal:, :] = 0
    return p


def _attend(q, k, v, cfg: AttnCfg):
    """q (B,S,Hp,D), k/v (B,T,Hkv,D) → (B, S, Hp·D); causal, logits and
    softmax in f32."""
    b, s, hp, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hp // hkv
    qg = q.reshape(b, s, hkv, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32)) * cfg.scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    logits = torch.where(kpos <= qpos, logits,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", attn, v)
    return out.reshape(b, s, hp * d)


def attention(p, x, *, tap: Tap, cfg: AttnCfg,
              positions: Optional[torch.Tensor] = None,
              group: str = "attn") -> torch.Tensor:
    """Full-sequence causal attention. positions: (S,) / (B,S) int.

    With ``cfg.flash`` and S a multiple of 128 the core runs through the
    flash kernels on (B, H, S, D) views of q, k and v (no copy); otherwise
    through ``_attend``. The ``S % 128`` test is the reference's dispatch
    (``attention.py:182-184``, whose other conditions — no cache, not
    cross, causal, no softcap, no local flag — always hold here), kept so
    that one configuration takes one route in both packages; the kernels
    themselves take any S, so it is not a fallback."""
    b, s, _ = x.shape
    q = linear(p["wq"], x, tap=tap, group=group)
    k = linear(p["wk"], x, tap=tap, group=group)
    v = linear(p["wv"], x, tap=tap, group=group)
    q = q.reshape(b, s, cfg.n_heads_p, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv, cfg.head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    elif positions.ndim == 1:
        positions = positions[None]
    ang = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, ang)
    k = apply_rope(k, ang)
    if cfg.flash and s % 128 == 0:
        y = ops.flash_attention_vjp(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), cfg.scale, None)
        y = y.transpose(1, 2).reshape(b, s, -1)
    else:
        y = _attend(q, k, v, cfg)
    return linear(p["wo"], y, tap=tap, group=group)
