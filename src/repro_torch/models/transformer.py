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
(B, 3, S) M-RoPE positions come with the batch. Not in this slice: LoRA,
``init_caches`` and ``forward_tokens`` (serving).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.attention import AttnCfg, attention, init_attention
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.mla import MlaCfg, init_mla, mla_attention
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
    dtype: str = "float32"

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
    any, are drawn first, in ``params["prefix"]``."""
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
    return params


def _block(p, x, tap: Tap, cfg: LMConfig, *, positions, local_flag=None,
           dense_mlp=False):
    def norm(q, y):
        return rmsnorm(q, y, tap=tap, eps=cfg.rms_eps,
                       plus_one=cfg.rms_plus_one)
    h = norm(p["ln_attn"], x)
    if cfg.mla is not None:
        a = mla_attention(p["attn"], h, tap=tap, cfg=cfg.mla,
                          positions=positions)
    else:
        a = attention(p["attn"], h, tap=tap, cfg=cfg.attn,
                      positions=positions, local_flag=local_flag)
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


def loss_fn(params, batch, tap: Tap, *, cfg: LMConfig):
    """Canonical instrumented loss: (loss_vec, aux)."""
    x = _inputs_to_embeds(params, batch, tap, cfg)
    positions = _positions(batch, cfg)
    for p in params.get("prefix", []):
        x = _block(p, x, tap, cfg, positions=positions, dense_mlp=True)
    for i, p in enumerate(params["blocks"]):
        local = (i % 2 == 0) if cfg.alt_local_global else None
        x = _block(p, x, tap, cfg, positions=positions, local_flag=local)
    x = rmsnorm(params["ln_f"], x, tap=tap, eps=cfg.rms_eps,
                plus_one=cfg.rms_plus_one)
    logits = lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}
