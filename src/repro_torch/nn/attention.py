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
otherwise the unfused ``_attend`` runs. Not ported: the decode KV cache
(``cache``, ``cache_index``), which comes with serving.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.taps import Tap
from repro_torch.kernels import ops
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
        return pm.pad_to(self.n_heads, self.head_multiple)

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None \
            else self.head_dim ** -0.5


def init_attention(gen: torch.Generator, cfg: AttnCfg, *, dtype, device):
    hq = cfg.n_heads_p * cfg.head_dim
    hkv = cfg.n_kv * cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": init_linear(gen, cfg.d_model, hq, bias=cfg.bias, **kw),
        "wk": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias, **kw),
        "wv": init_linear(gen, cfg.d_model, hkv, bias=cfg.bias, **kw),
        "wo": init_linear(gen, hq, cfg.d_out or cfg.d_model, bias=False,
                          **kw),
    }
    hreal = cfg.n_heads * cfg.head_dim
    p["wq"]["w"][:, hreal:] = 0     # padded heads → exact
    p["wo"]["w"][hreal:, :] = 0
    return p


def _attend(q, k, v, cfg: AttnCfg, local_flag: Optional[bool] = None):
    """q (B,S,Hp,D), k/v (B,T,Hkv,D) → (B, S, Hp·D); logits (then the
    softcap) and softmax in f32. The causal mask applies when
    ``cfg.causal and not cfg.cross``; ``cfg.window`` applies where
    ``local_flag`` is None or True (gemma2's local layers), not where it is
    False (its global ones)."""
    b, s, hp, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hp // hkv
    qg = q.reshape(b, s, hkv, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32)) * cfg.scale
    if cfg.softcap is not None:
        logits = cfg.softcap * torch.tanh(logits / cfg.softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if cfg.causal and not cfg.cross:
        mask = mask & (kpos <= qpos)
    if cfg.window is not None and local_flag is not False:
        mask = mask & ((qpos - kpos) < cfg.window)
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
    """Full-sequence attention. positions: (S,) / (B,S) int, or (3,B,S)
    for M-RoPE (a 2-D stream is broadcast to all three sections, the
    text-only fallback). ``memory`` (B, T, d_model): the encoder output
    that k and v project from under ``cfg.cross`` (no RoPE then, and no
    mask). ``local_flag``: gemma2's per-layer switch of the window (see
    ``_attend``), a Python bool. A decode ``cache`` raises.

    With ``cfg.flash`` the core runs through the flash kernels on (B, H,
    S, D) views of q, k and v (no copy, ``cfg.window`` passed on) under the
    reference's gate (``attention.py:182-184``): causal self-attention, no
    softcap, no local flag and S a multiple of 128 (the reference's cache
    condition holds here, as the cache is not ported). Otherwise
    ``_attend`` runs. The gate is the reference's dispatch, kept so that
    one configuration takes one route in both packages; the kernels
    themselves take a softcap, a window and any S, so it is not a
    fallback."""
    if cache is not None or cache_index is not None:
        raise NotImplementedError(
            "attention's decode KV cache comes with serving: ROADMAP Queue 1 "
            "item 8")
    if cfg.cross and memory is None:
        raise ValueError("cross-attention needs the encoder's memory")
    b, s, _ = x.shape
    kv_src = memory if cfg.cross else x
    t = kv_src.shape[1]
    q = linear(p["wq"], x, tap=tap, group=group)
    k = linear(p["wk"], kv_src, tap=tap, group=group)
    v = linear(p["wv"], kv_src, tap=tap, group=group)
    q = q.reshape(b, s, cfg.n_heads_p, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv, cfg.head_dim)
    if not cfg.cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
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
    if (cfg.flash and cfg.causal and not cfg.cross and cfg.softcap is None
            and local_flag is None and s % 128 == 0):
        y = ops.flash_attention_vjp(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), cfg.scale, cfg.window)
        y = y.transpose(1, 2).reshape(b, s, -1)
    else:
        y = _attend(q, k, v, cfg, local_flag)
    return linear(p["wo"], y, tap=tap, group=group)
