"""Multi-head Latent Attention (DeepSeek-V2).

Port of ``src/repro/nn/mla.py``. Training (no cache) runs the expanded
form: the latent KV is projected up for every position (matmul-friendly),
so the per-example norm
machinery sees MLA as five ordinary tapped matmuls (``q_down``, ``q_up``,
``kv_down``, ``kv_up``, ``wo``) and two RMSNorm scale taps (``q_norm`` on
the query latent, ``kv_norm`` on the 512-d KV latent only; the 64-d rope
key split off ``kv_down``'s output bypasses it). The rope key is one key
shared by every head: rotated once, then broadcast across the heads.

The attention core is plain torch, as the reference's is plain XLA: f32
scores × ``scale``, the causal mask, softmax, a cast to the input dtype,
then ``· v``. There is no flash route: the qk head dim (nope + rope = 192
at full width) is none of the flash kernels' head dims, and v's differs
from it.

Serving (a ``cache`` from ``init_mla_cache``, prefill and decode alike)
runs the *absorbed* form: the cache holds each position's normed 512-d
latent and its rotated 64-d rope key (576 values a token instead of
2·H·D), and kv_up's key and value blocks are folded into the query and the
output, so the scores are taken against the latent directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn.attention import NEG_INF
from repro_torch.nn.linear import init_linear, linear
from repro_torch.nn.norms import init_rmsnorm, rmsnorm
from repro_torch.nn.rotary import apply_rope, rope_angles


@dataclasses.dataclass(frozen=True)
class MlaCfg:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def scale(self) -> float:
        return (self.qk_nope + self.qk_rope) ** -0.5


def init_mla(gen: torch.Generator, cfg: MlaCfg, *, dtype, device):
    """The seven parameters, each linear with fan-in std, the two norm
    gains ones."""
    h = cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "q_down": init_linear(gen, cfg.d_model, cfg.q_lora, **kw),
        "q_norm": init_rmsnorm(cfg.q_lora, **kw),
        "q_up": init_linear(gen, cfg.q_lora, h * (cfg.qk_nope + cfg.qk_rope),
                            **kw),
        "kv_down": init_linear(gen, cfg.d_model, cfg.kv_lora + cfg.qk_rope,
                               **kw),
        "kv_norm": init_rmsnorm(cfg.kv_lora, **kw),
        "kv_up": init_linear(gen, cfg.kv_lora, h * (cfg.qk_nope + cfg.v_dim),
                             **kw),
        "wo": init_linear(gen, h * cfg.v_dim, cfg.d_model, **kw),
    }


def init_mla_cache(batch: int, max_len: int, cfg: MlaCfg, *, dtype,
                   device):
    """Zero latent (B, max_len, kv_lora) and rope-key (B, max_len,
    qk_rope) buffers of one layer."""
    return {"ckv": torch.zeros(batch, max_len, cfg.kv_lora, dtype=dtype,
                               device=device),
            "krope": torch.zeros(batch, max_len, cfg.qk_rope, dtype=dtype,
                                 device=device)}


def _project_q(p, x, tap, cfg: MlaCfg, group):
    b, s, _ = x.shape
    q = linear(p["q_down"], x, tap=tap, group=group)
    q = rmsnorm(p["q_norm"], q, tap=tap)
    q = linear(p["q_up"], q, tap=tap, group=group)
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_nope + cfg.qk_rope)
    return q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]


def _latent_kv(p, x, tap, cfg: MlaCfg, group):
    ckv = linear(p["kv_down"], x, tap=tap, group=group)
    c, krope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    c = rmsnorm(p["kv_norm"], c, tap=tap)
    return c, krope


def _attend(q, k, v, scale: float) -> torch.Tensor:
    """q, k (B, S, H, D_qk), v (B, S, H, D_v) → (B, S, H·D_v): causal, the
    scores (taken in f32 from the input-dtype operands, as
    ``attention._attend`` takes them: no rounding before the scale) and the
    softmax in f32, the probabilities cast to v's dtype."""
    b, s = q.shape[:2]
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    mask = torch.arange(s, device=q.device)[None, :] <= qpos
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", attn, v).reshape(b, s, -1)


def _absorbed(p, q_nope, q_rope, cache, cfg: MlaCfg, cache_index: int,
              dtype) -> torch.Tensor:
    """The reference's absorbed decode form over the cache's rows [0,
    kv_len): q_lat = q_nope · wk in the input dtype, scores q_lat · ckv +
    q_rope · krope in f32 times ``scale``, masked to kpos ≤ qpos and kpos <
    kv_len, softmax in f32 cast to ``dtype``, o = (attn · ckv) · wv →
    (B, S, H·v_dim). Attending over the written rows alone is the
    reference's masked full buffer (``attention.attention``)."""
    b, s = q_nope.shape[:2]
    kv_len = cache_index + s
    c_all = cache["ckv"][:, :kv_len]
    krope_all = cache["krope"][:, :kv_len]
    wkv = p["kv_up"]["w"].reshape(cfg.kv_lora, cfg.n_heads,
                                  cfg.qk_nope + cfg.v_dim)
    wk, wv = wkv[..., :cfg.qk_nope], wkv[..., cfg.qk_nope:]
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wk)
    f32 = torch.float32
    scores = (torch.einsum("bshl,btl->bhst", q_lat.to(f32), c_all.to(f32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                             krope_all.to(f32))) * cfg.scale
    qpos = cache_index + torch.arange(s, device=q_nope.device)[:, None]
    kpos = torch.arange(kv_len, device=q_nope.device)[None, :]
    mask = (kpos <= qpos) & (kpos < kv_len)
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=scores.device))
    attn = torch.softmax(scores, dim=-1).to(dtype)
    o_lat = torch.einsum("bhst,btl->bshl", attn, c_all)
    return torch.einsum("bshl,lhd->bshd", o_lat, wv).reshape(b, s, -1)


def mla_attention(p, x, *, tap: Tap, cfg: MlaCfg,
                  positions: Optional[torch.Tensor] = None,
                  cache=None, cache_index=None,
                  group: str = "attn") -> torch.Tensor:
    """Causal MLA. positions: (S,) or (B, S) int, default ``cache_index +
    arange(S)`` (0 without a cache). Without a cache the expanded form
    (train/prefill); with a ``cache`` (``init_mla_cache``) and
    ``cache_index`` (an int) the new latent and rope-key rows are written
    into it in place at [cache_index, cache_index + S) and the absorbed
    form (``_absorbed``) attends over the rows written so far."""
    if cache is not None and cache_index is None:
        raise ValueError("an MLA cache needs its cache_index")
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, x, tap, cfg, group)
    c, krope = _latent_kv(p, x, tap, cfg, group)

    if positions is None:
        start = 0 if cache_index is None else cache_index
        positions = start + torch.arange(s, device=x.device)
    ang = rope_angles(positions, cfg.qk_rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, ang)
    krope = apply_rope(krope[:, :, None, :], ang)[:, :, 0, :]

    if cache is not None:
        cache["ckv"][:, cache_index:cache_index + s] = c
        cache["krope"][:, cache_index:cache_index + s] = krope
        o = _absorbed(p, q_nope, q_rope, cache, cfg, cache_index, x.dtype)
        return linear(p["wo"], o, tap=tap, group=group)
    kv = linear(p["kv_up"], c, tap=tap, group=group)
    kv = kv.reshape(b, s, cfg.n_heads, cfg.qk_nope + cfg.v_dim)
    k_nope, v = kv[..., :cfg.qk_nope], kv[..., cfg.qk_nope:]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, s, cfg.n_heads, cfg.qk_rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _attend(q, k, v, cfg.scale)
    return linear(p["wo"], o, tap=tap, group=group)
