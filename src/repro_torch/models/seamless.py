"""SeamlessM4T-medium backbone: transformer encoder–decoder.

Port of ``src/repro/models/seamless.py``. The audio
frontend is a stub, as in the reference: the batch's ``src_frames`` are
precomputed frame embeddings (B, S_src, d_model). The encoder is
non-causal with a plain gelu MLP; each decoder block runs causal
self-attention, then cross-attention on the encoder's memory, then the
MLP, with teacher forcing. The reference stacks ``enc`` and ``dec`` for
``lax.scan``; the port keeps a list of per-block dicts for each and runs
them in Python loops without layer recompute.

At token granularity the encoder's taps see source-frame rows, and frame
t's stat lands at target token t, as in the reference (its batches have
S_src = S).

Serving: ``init_caches`` holds each decoder layer's self-attention KV cache
(``self``), its cross-attention K and V of the encoder memory (``cross``)
and the memory itself; ``forward_tokens`` with ``src_frames`` encodes the
source and fills ``memory`` and ``cross`` (``precompute_cross``), and
without them decodes against what the prefill left, writing the self caches
in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.attention import (AttnCfg, attention, init_attention,
                                      init_kv_cache)
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.linear import linear
from repro_torch.nn.mlp import MlpCfg, init_mlp, mlp
from repro_torch.nn.norms import init_layernorm, layernorm


@dataclasses.dataclass(frozen=True)
class SeamlessConfig:
    name: str
    n_enc: int = 12
    n_dec: int = 12
    d_model: int = 1024
    n_heads: int = 16
    kv_heads: int = 16
    d_ff: int = 4096
    vocab: int = 256206
    dtype: str = "float32"
    max_cache_len: int = 0                # set by serving_config
    max_src_len: int = 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return pm.torch_dtype(self.dtype)

    @property
    def n_layers(self) -> int:
        return self.n_enc + self.n_dec

    def attn_cfg(self, *, cross: bool = False, causal: bool = True) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv=self.kv_heads,
                       head_dim=self.d_model // self.n_heads,
                       cross=cross, causal=causal)

    @property
    def mlp_cfg(self) -> MlpCfg:
        return MlpCfg(self.d_model, self.d_ff, act="gelu", gated=False)

    @property
    def vocab_cfg(self) -> VocabCfg:
        return VocabCfg(self.vocab, self.d_model)


def _init_enc_block(gen, cfg: SeamlessConfig, kw):
    return {"ln1": init_layernorm(cfg.d_model, **kw),
            "attn": init_attention(gen, cfg.attn_cfg(causal=False), **kw),
            "ln2": init_layernorm(cfg.d_model, **kw),
            "mlp": init_mlp(gen, cfg.mlp_cfg, **kw)}


def _init_dec_block(gen, cfg: SeamlessConfig, kw):
    return {"ln1": init_layernorm(cfg.d_model, **kw),
            "self": init_attention(gen, cfg.attn_cfg(), **kw),
            "ln_x": init_layernorm(cfg.d_model, **kw),
            "cross": init_attention(gen, cfg.attn_cfg(cross=True), **kw),
            "ln2": init_layernorm(cfg.d_model, **kw),
            "mlp": init_mlp(gen, cfg.mlp_cfg, **kw)}


def init(cfg: SeamlessConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's distributions, drawn from
    ``generator`` on ``device`` (default CUDA)."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "embed": init_embedding(generator, cfg.vocab_cfg, **kw),
        "head": init_lm_head(generator, cfg.vocab_cfg, **kw),
        "ln_enc": init_layernorm(cfg.d_model, **kw),
        "ln_dec": init_layernorm(cfg.d_model, **kw),
        "enc": [_init_enc_block(generator, cfg, kw)
                for _ in range(cfg.n_enc)],
        "dec": [_init_dec_block(generator, cfg, kw)
                for _ in range(cfg.n_dec)],
    }


def _encode(params, frames, tap: Tap, cfg: SeamlessConfig):
    x = frames
    for p in params["enc"]:
        h = layernorm(p["ln1"], x, tap=tap)
        x = x + attention(p["attn"], h, tap=tap,
                          cfg=cfg.attn_cfg(causal=False))
        h = layernorm(p["ln2"], x, tap=tap)
        x = x + mlp(p["mlp"], h, tap=tap, cfg=cfg.mlp_cfg)
    return layernorm(params["ln_enc"], x, tap=tap)


def _dec_block(p, x, memory, tap: Tap, cfg: SeamlessConfig, *,
               self_cache=None, cross_cache=None, cache_index=None):
    h = layernorm(p["ln1"], x, tap=tap)
    x = x + attention(p["self"], h, tap=tap, cfg=cfg.attn_cfg(),
                      cache=self_cache, cache_index=cache_index)
    h = layernorm(p["ln_x"], x, tap=tap)
    x = x + attention(p["cross"], h, tap=tap, cfg=cfg.attn_cfg(cross=True),
                      memory=memory, cache=cross_cache)
    h = layernorm(p["ln2"], x, tap=tap)
    return x + mlp(p["mlp"], h, tap=tap, cfg=cfg.mlp_cfg)


def loss_fn(params, batch, tap: Tap, *, cfg: SeamlessConfig):
    """batch: src_frames (B,S_src,d), ids/labels (B,S_tgt) → (loss_vec,
    aux)."""
    memory = _encode(params, batch["src_frames"], tap, cfg)
    x = embed(params["embed"], batch["ids"], tap=tap, cfg=cfg.vocab_cfg)
    for p in params["dec"]:
        x = _dec_block(p, x, memory, tap, cfg)
    x = layernorm(params["ln_dec"], x, tap=tap)
    logits = lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}


def init_caches(batch: int, cfg: SeamlessConfig, device=None):
    """Zero serving caches for ``batch`` slots on ``device`` (default
    CUDA): per decoder layer a self-attention KV cache of
    ``max_cache_len`` rows (``self``) and a cross K/V of ``max_src_len``
    rows (``cross``), and the memory (B, max_src_len, d_model); a prefill
    with ``src_frames`` replaces ``cross`` and ``memory``."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {"self": [init_kv_cache(batch, cfg.max_cache_len, cfg.attn_cfg(),
                                   **kw) for _ in range(cfg.n_dec)],
            "cross": [init_kv_cache(batch, cfg.max_src_len,
                                    cfg.attn_cfg(cross=True), **kw)
                      for _ in range(cfg.n_dec)],
            "memory": torch.zeros(batch, cfg.max_src_len, cfg.d_model,
                                  **kw)}


def precompute_cross(params, memory, *, cfg: SeamlessConfig):
    """Every decoder layer's cross-attention K and V of the encoder
    ``memory`` (B, T, d_model): a list of {"k", "v"} (B, T, n_kv,
    head_dim)."""
    hd = cfg.d_model // cfg.n_heads
    out = []
    for p in params["dec"]:
        k = linear(p["cross"]["wk"], memory, tap=taps.NULL)
        v = linear(p["cross"]["wv"], memory, tap=taps.NULL)
        out.append({"k": k.reshape(*k.shape[:2], cfg.kv_heads, hd),
                    "v": v.reshape(*v.shape[:2], cfg.kv_heads, hd)})
    return out


def forward_tokens(params, batch, caches, cache_index, *,
                   cfg: SeamlessConfig):
    """Prefill or decode, uninstrumented (``taps.NULL``, inference mode):
    batch["ids"] (B, s) at ``cache_index`` → (logits (B, s, vocab_p),
    caches). With batch["src_frames"] (prefill) the source is encoded and
    ``caches["memory"]`` and ``caches["cross"]`` are replaced; the decoder
    then reads them, and writes its self caches in place."""
    tap = taps.NULL
    with torch.inference_mode():
        if "src_frames" in batch:
            memory = _encode(params, batch["src_frames"], tap, cfg)
            caches["memory"] = memory
            caches["cross"] = precompute_cross(params, memory, cfg=cfg)
        x = embed(params["embed"], batch["ids"], tap=tap, cfg=cfg.vocab_cfg)
        for i, p in enumerate(params["dec"]):
            x = _dec_block(p, x, caches["memory"], tap, cfg,
                           self_cache=caches["self"][i],
                           cross_cache=caches["cross"][i],
                           cache_index=cache_index)
        x = layernorm(params["ln_dec"], x, tap=tap)
        logits = lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)
    return logits, caches
