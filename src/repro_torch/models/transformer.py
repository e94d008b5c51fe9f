"""Decoder-only LM, GQA stack with a dense or MoE FFN (llama3.2-1b,
phi3.5-moe).

Port of ``src/repro/models/transformer.py`` for the GQA family. The
reference stacks the layers and runs them under ``lax.scan`` with
``jax.checkpoint``; the port keeps one parameter dict per layer in
``params["blocks"]`` (a list) and runs them in a Python loop without
recompute — at llama3.2-1b width, B=8 and S=512 the saved activations fit
an 80 GB card with room to spare. ``interop`` converts between the
reference's stacked layout and this one.

Each block's FFN is ``mlp`` or, when the config has ``moe``, ``nn.moe``.
Not in this slice: MLA, LoRA, dense prefixes, gemma's norms and softcaps,
vision inputs, ``init_caches`` and ``forward_tokens`` (serving).
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
from repro_torch.nn.mlp import MlpCfg, init_mlp, mlp
from repro_torch.nn.moe import MoeCfg, init_moe, moe
from repro_torch.nn.norms import init_rmsnorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    attn: AttnCfg
    mlp: Optional[MlpCfg] = None          # dense FFN
    moe: Optional[MoeCfg] = None          # MoE FFN (takes precedence)
    rms_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return pm.torch_dtype(self.dtype)

    @property
    def vocab_cfg(self) -> VocabCfg:
        return VocabCfg(self.vocab, self.d_model)


def _init_block(gen, cfg: LMConfig, device):
    kw = dict(dtype=cfg.torch_dtype, device=device)
    p = {
        "ln_attn": init_rmsnorm(cfg.d_model, **kw),
        "attn": init_attention(gen, cfg.attn, **kw),
        "ln_mlp": init_rmsnorm(cfg.d_model, **kw),
    }
    if cfg.moe is None:
        p["mlp"] = init_mlp(gen, cfg.mlp, **kw)
    else:
        p["moe"] = init_moe(gen, cfg.moe, **kw)
    return p


def init(cfg: LMConfig, generator: torch.Generator, device=None):
    """Random parameters with the reference's distributions (std 0.02 for
    embed/head, fan-in for linear layers, ones for RMSNorm gains), drawn
    from ``generator`` on ``device`` (default CUDA)."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "embed": init_embedding(generator, cfg.vocab_cfg, **kw),
        "head": init_lm_head(generator, cfg.vocab_cfg, **kw),
        "ln_f": init_rmsnorm(cfg.d_model, **kw),
        "blocks": [_init_block(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }


def _block(p, x, tap: Tap, cfg: LMConfig):
    h = rmsnorm(p["ln_attn"], x, tap=tap, eps=cfg.rms_eps)
    x = x + attention(p["attn"], h, tap=tap, cfg=cfg.attn)
    h = rmsnorm(p["ln_mlp"], x, tap=tap, eps=cfg.rms_eps)
    if "moe" in p:
        return x + moe(p["moe"], h, tap=tap, cfg=cfg.moe)
    return x + mlp(p["mlp"], h, tap=tap, cfg=cfg.mlp)


def loss_fn(params, batch, tap: Tap, *, cfg: LMConfig):
    """Canonical instrumented loss: (loss_vec, aux)."""
    x = embed(params["embed"], batch["ids"], tap=tap, cfg=cfg.vocab_cfg)
    for p in params["blocks"]:
        x = _block(p, x, tap, cfg)
    x = rmsnorm(params["ln_f"], x, tap=tap, eps=cfg.rms_eps)
    logits = lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}
