"""Multi-head Latent Attention (DeepSeek-V2) at training time.

Port of ``src/repro/nn/mla.py``'s expanded form: the latent KV is
projected up for every position (matmul-friendly), so the per-example norm
machinery sees MLA as five ordinary tapped matmuls (``q_down``, ``q_up``,
``kv_down``, ``kv_up``, ``wo``) and two RMSNorm scale taps (``q_norm`` on
the query latent, ``kv_norm`` on the 512-d KV latent only; the 64-d rope
key split off ``kv_down``'s output bypasses it). The rope key is one key
shared by every head: rotated once, then broadcast across the heads.

The attention core is plain torch, as the reference's is plain XLA: f32
scores × ``scale``, the causal mask, softmax, a cast to the input dtype,
then ``· v``. There is no flash route: the qk head dim (nope + rope = 192
at full width) is none of the flash kernels' head dims, and v's differs
from it. Not ported: the decode cache and its absorbed latent form
(``init_mla_cache``), which wait for serving.
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


def mla_attention(p, x, *, tap: Tap, cfg: MlaCfg,
                  positions: Optional[torch.Tensor] = None,
                  cache=None, group: str = "attn") -> torch.Tensor:
    """Full-sequence causal MLA (train/prefill). positions: (S,) or (B, S)
    int, default the arange. A decode ``cache`` is not ported."""
    if cache is not None:
        raise NotImplementedError(
            "mla_attention's decode cache (the absorbed latent form) comes "
            "with serving: ROADMAP Queue 1 item 8")
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, x, tap, cfg, group)
    c, krope = _latent_kv(p, x, tap, cfg, group)

    if positions is None:
        positions = torch.arange(s, device=x.device)
    ang = rope_angles(positions, cfg.qk_rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, ang)
    krope = apply_rope(krope[:, :, None, :], ang)[:, :, 0, :]

    kv = linear(p["kv_up"], c, tap=tap, group=group)
    kv = kv.reshape(b, s, cfg.n_heads, cfg.qk_nope + cfg.v_dim)
    k_nope, v = kv[..., :cfg.qk_nope], kv[..., cfg.qk_nope:]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, s, cfg.n_heads, cfg.qk_rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = _attend(q, k, v, cfg.scale)
    return linear(p["wo"], o, tap=tap, group=group)
