"""RWKV6-3B ("Finch"): attention-free LM; blocks of time mix + channel mix.

Port of ``src/repro/models/rwkv6.py`` at training time. The reference
stacks the blocks for ``lax.scan`` with ``jax.checkpoint``; the port keeps
one parameter dict per block in ``params["blocks"]`` (a list) and runs them
in a Python loop without layer recompute. Each block's WKV recurrence
keeps one state per ``nn.rwkv.CHUNK`` steps for its backward (see
``nn.rwkv``). Decode (``init_caches``, ``forward_tokens``: the O(1) wkv
state and token-shift rows) comes with serving.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.norms import init_layernorm, layernorm
from repro_torch.nn.rwkv import (RwkvCfg, init_rwkv_cmix, init_rwkv_tmix,
                                 rwkv_cmix, rwkv_tmix)


@dataclasses.dataclass(frozen=True)
class Rwkv6Config:
    name: str
    n_layers: int = 32
    d_model: int = 2560
    vocab: int = 65536
    d_ff: int = 8960
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return pm.torch_dtype(self.dtype)

    @property
    def rwkv_cfg(self) -> RwkvCfg:
        return RwkvCfg(self.d_model, self.d_ff)

    @property
    def vocab_cfg(self) -> VocabCfg:
        return VocabCfg(self.vocab, self.d_model)


def _init_block(gen, cfg: Rwkv6Config, kw):
    return {
        "ln1": init_layernorm(cfg.d_model, **kw),
        "tmix": init_rwkv_tmix(gen, cfg.rwkv_cfg, **kw),
        "ln2": init_layernorm(cfg.d_model, **kw),
        "cmix": init_rwkv_cmix(gen, cfg.rwkv_cfg, **kw),
    }


def init(cfg: Rwkv6Config, generator: torch.Generator, device=None):
    """Random parameters with the reference's distributions, drawn from
    ``generator`` on ``device`` (default CUDA)."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    params = {
        "embed": init_embedding(generator, cfg.vocab_cfg, **kw),
        "ln_in": init_layernorm(cfg.d_model, **kw),
        "head": init_lm_head(generator, cfg.vocab_cfg, **kw),
        "ln_f": init_layernorm(cfg.d_model, **kw),
    }
    params["blocks"] = [_init_block(generator, cfg, kw)
                        for _ in range(cfg.n_layers)]
    return params


def _block(p, x, tap: Tap, cfg: Rwkv6Config):
    h = layernorm(p["ln1"], x, tap=tap)
    x = x + rwkv_tmix(p["tmix"], h, tap=tap, cfg=cfg.rwkv_cfg)
    h = layernorm(p["ln2"], x, tap=tap)
    return x + rwkv_cmix(p["cmix"], h, tap=tap, cfg=cfg.rwkv_cfg)


def loss_fn(params, batch, tap: Tap, *, cfg: Rwkv6Config):
    """Canonical instrumented loss: (loss_vec, aux)."""
    x = embed(params["embed"], batch["ids"], tap=tap, cfg=cfg.vocab_cfg)
    x = layernorm(params["ln_in"], x, tap=tap)
    for p in params["blocks"]:
        x = _block(p, x, tap, cfg)
    x = layernorm(params["ln_f"], x, tap=tap)
    logits = lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}
