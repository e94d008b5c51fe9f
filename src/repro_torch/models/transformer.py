"""Decoder-only LM with GQA or MLA attention and a dense or MoE FFN:
llama3.2-1b, qwen2-7b, qwen2-vl-7b, minitron-4b, gemma2-9b, phi3.5-moe and
deepseek-v2-236b.

Port of ``src/repro/models/transformer.py``. The reference stacks the
homogeneous layers and runs them under ``lax.scan`` with
``jax.checkpoint``; the port keeps one parameter dict per layer in
``params["blocks"]`` (a list) and runs them in a Python loop without
recompute — at llama3.2-1b width, B=8 and S=512 the saved activations fit
an 80 GB card with room to spare. Heterogeneous prefix layers
(deepseek's first dense layer) sit in ``params["prefix"]``, a list as in
the reference, and run before the blocks. ``interop`` converts between the
reference's stacked layout and this one.

Each block's attention is ``nn.attention`` (GQA, ``cfg.attn``) or
``nn.mla`` (``cfg.mla``); its FFN is ``mlp`` or, when the config has
``moe``, ``nn.moe``, except in the prefix layers, which take
``dense_prefix_mlp``. gemma2's features are config switches: ``(1+g)``
RMSNorm gains, sandwich norms after attention and the FFN, even layers
local (windowed; counted over ``blocks`` only, as the reference's scan
index is), the final logit softcap and embeds × √d. qwen2-vl's merged
visual embeds replace the token embeds where ``vis_mask`` is set, and its
(B, 3, S) M-RoPE positions come with the batch. ``cfg.lora`` LoRA-fies
the linear sites after ``init`` (``nn.lora.attach``): frozen bases and
tapped factors, each layer's pair its own (``blocks`` is a list).

Serving: ``init_caches`` gives one KV (or MLA latent) cache per layer,
``{"prefix": [...], "blocks": [...]}`` in the layout of ``params``, and
``forward_tokens`` runs a prefill or a decode step through them,
uninstrumented. It writes the caches in place (a functional copy would copy
every layer's whole buffer at every token) and returns the same dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.attention import (AttnCfg, attention, init_attention,
                                      init_kv_cache)
from repro_torch.nn import lora as lora_mod
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.mla import MlaCfg, init_mla, init_mla_cache, mla_attention
from repro_torch.nn.mlp import MlpCfg, init_mlp, mlp
from repro_torch.nn.moe import MoeCfg, init_moe, moe
from repro_torch.nn.norms import init_rmsnorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    attn: Optional[AttnCfg] = None        # GQA family
    mla: Optional[MlaCfg] = None          # deepseek
    mlp: Optional[MlpCfg] = None          # dense FFN
    moe: Optional[MoeCfg] = None          # MoE FFN (takes precedence)
    n_dense_prefix: int = 0               # deepseek: first k layers dense
    dense_prefix_mlp: Optional[MlpCfg] = None
    rms_eps: float = 1e-6
    rms_plus_one: bool = False            # gemma (1+g)
    post_norms: bool = False              # gemma2 sandwich norms
    alt_local_global: bool = False        # gemma2 even layers local
    logit_softcap: Optional[float] = None
    scale_embeds: bool = False            # gemma ×√d
    vl_inputs: bool = False               # qwen2-vl merged visual embeds
    lora: Optional[lora_mod.LoraCfg] = None  # LoRA-fy the linear sites:
                                          # frozen bases + tapped factors
    dtype: str = "float32"
    max_cache_len: int = 0                # set by serving_config

    @property
    def torch_dtype(self) -> torch.dtype:
        return pm.torch_dtype(self.dtype)

    @property
    def vocab_cfg(self) -> VocabCfg:
        return VocabCfg(self.vocab, self.d_model,
                        logit_softcap=self.logit_softcap,
                        scale_by_sqrt_dim=self.scale_embeds)


def _ffn_cfg(cfg: LMConfig, dense_mlp: bool) -> MlpCfg:
    """A dense layer's MLP: the prefix's own where the config has one."""
    return cfg.dense_prefix_mlp if dense_mlp and cfg.dense_prefix_mlp \
        else cfg.mlp


def _init_block(gen, cfg: LMConfig, device, *, dense_mlp: bool = False):
    kw = dict(dtype=cfg.torch_dtype, device=device)
    norm = dict(kw, plus_one=cfg.rms_plus_one)
    p = {
        "ln_attn": init_rmsnorm(cfg.d_model, **norm),
        "attn": (init_mla(gen, cfg.mla, **kw) if cfg.mla is not None
                 else init_attention(gen, cfg.attn, **kw)),
        "ln_mlp": init_rmsnorm(cfg.d_model, **norm),
    }
    if dense_mlp or cfg.moe is None:
        p["mlp"] = init_mlp(gen, _ffn_cfg(cfg, dense_mlp), **kw)
    else:
        p["moe"] = init_moe(gen, cfg.moe, **kw)
    if cfg.post_norms:
        p["ln_attn_post"] = init_rmsnorm(cfg.d_model, **norm)
        p["ln_mlp_post"] = init_rmsnorm(cfg.d_model, **norm)
    return p


def init(cfg: LMConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's distributions (std 0.02 for
    embed/head, fan-in for linear layers, ones for RMSNorm gains, zeros
    for gemma's ``(1+g)`` ones), drawn from ``generator`` on ``device``
    (default CUDA). The ``n_dense_prefix`` prefix layers, when there are
    any, are drawn first, in ``params["prefix"]``. With ``cfg.lora`` the
    linear sites then get their adapters (A fan-in normal, B zero)."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    params = {
        "embed": init_embedding(generator, cfg.vocab_cfg, **kw),
        "head": init_lm_head(generator, cfg.vocab_cfg, **kw),
        "ln_f": init_rmsnorm(cfg.d_model, plus_one=cfg.rms_plus_one, **kw),
    }
    n_pre = cfg.n_dense_prefix
    if n_pre:
        params["prefix"] = [_init_block(generator, cfg, device,
                                        dense_mlp=True)
                            for _ in range(n_pre)]
    params["blocks"] = [_init_block(generator, cfg, device)
                        for _ in range(cfg.n_layers - n_pre)]
    if cfg.lora is not None:
        # after the base weights: the adapters' seed is the generator's
        # next draw, and each site's factors draw from that seed folded
        # with the site's path
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
        params = lora_mod.attach(params, cfg.lora, seed,
                                 dtype=cfg.torch_dtype, device=device)
    return params


def _block(p, x, tap: Tap, cfg: LMConfig, *, positions, local_flag=None,
           dense_mlp=False, cache=None, cache_index=None):
    def norm(q, y):
        return rmsnorm(q, y, tap=tap, eps=cfg.rms_eps,
                       plus_one=cfg.rms_plus_one)
    h = norm(p["ln_attn"], x)
    if cfg.mla is not None:
        a = mla_attention(p["attn"], h, tap=tap, cfg=cfg.mla,
                          positions=positions, cache=cache,
                          cache_index=cache_index)
    else:
        a = attention(p["attn"], h, tap=tap, cfg=cfg.attn,
                      positions=positions, local_flag=local_flag,
                      cache=cache, cache_index=cache_index)
    if cfg.post_norms:
        a = norm(p["ln_attn_post"], a)
    x = x + a
    h = norm(p["ln_mlp"], x)
    if "moe" in p and not dense_mlp:
        m = moe(p["moe"], h, tap=tap, cfg=cfg.moe)
    else:
        m = mlp(p["mlp"], h, tap=tap, cfg=_ffn_cfg(cfg, dense_mlp))
    if cfg.post_norms:
        m = norm(p["ln_mlp_post"], m)
    return x + m


def _inputs_to_embeds(params, batch, tap: Tap, cfg: LMConfig):
    x = embed(params["embed"], batch["ids"], tap=tap, cfg=cfg.vocab_cfg)
    if cfg.vl_inputs and "vis_embeds" in batch:
        # merged multimodal stream: the frontend (a stub) supplies the
        # patch embeds
        x = torch.where(batch["vis_mask"][..., None], batch["vis_embeds"],
                        x)
    return x


def _positions(batch, cfg: LMConfig):
    """(3, B, S) M-RoPE streams from the batch's (B, 3, S) ``positions``,
    or None (the default arange)."""
    if cfg.attn is not None and cfg.attn.mrope_sections is not None:
        pos = batch.get("positions")
        return None if pos is None else pos.movedim(1, 0)
    return None


def _run(params, x, tap: Tap, cfg: LMConfig, *, positions, caches=None,
         cache_index=None):
    """The prefix layers, then the blocks (gemma2's even blocks local),
    each with its cache when ``caches`` is given."""
    for i, p in enumerate(params.get("prefix", [])):
        c = None if caches is None else caches["prefix"][i]
        x = _block(p, x, tap, cfg, positions=positions, dense_mlp=True,
                   cache=c, cache_index=cache_index)
    for i, p in enumerate(params["blocks"]):
        local = (i % 2 == 0) if cfg.alt_local_global else None
        c = None if caches is None else caches["blocks"][i]
        x = _block(p, x, tap, cfg, positions=positions, local_flag=local,
                   cache=c, cache_index=cache_index)
    x = rmsnorm(params["ln_f"], x, tap=tap, eps=cfg.rms_eps,
                plus_one=cfg.rms_plus_one)
    return lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)


def loss_fn(params, batch, tap: Tap, *, cfg: LMConfig):
    """Canonical instrumented loss: (loss_vec, aux)."""
    x = _inputs_to_embeds(params, batch, tap, cfg)
    logits = _run(params, x, tap, cfg, positions=_positions(batch, cfg))
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}


def init_caches(batch: int, cfg: LMConfig, device=None):
    """Zero decode caches of ``cfg.max_cache_len`` rows for ``batch``
    slots on ``device`` (default CUDA): one per prefix layer and one per
    block, MLA's latent caches for an MLA config, else KV caches."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)

    def one():
        if cfg.mla is not None:
            return init_mla_cache(batch, cfg.max_cache_len, cfg.mla, **kw)
        return init_kv_cache(batch, cfg.max_cache_len, cfg.attn, **kw)
    n_pre = cfg.n_dense_prefix
    return {"prefix": [one() for _ in range(n_pre)],
            "blocks": [one() for _ in range(cfg.n_layers - n_pre)]}


def forward_tokens(params, batch, caches, cache_index, *, cfg: LMConfig):
    """Prefill or decode, uninstrumented (``taps.NULL``, inference mode):
    batch["ids"] (B, s) at positions ``cache_index + arange(s)`` (qwen2-vl:
    the batch's (B, 3, s) ``positions`` where given) → (logits (B, s,
    vocab_p), caches). ``caches`` (``init_caches``) are written in place
    and returned; with ``caches`` None it is the full forward."""
    tap = taps.NULL
    with torch.inference_mode():
        x = _inputs_to_embeds(params, batch, tap, cfg)
        logits = _run(params, x, tap, cfg, positions=_positions(batch, cfg),
                      caches=caches, cache_index=cache_index)
    return logits, caches
