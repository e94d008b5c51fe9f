"""RWKV6-3B ("Finch"): attention-free LM; blocks of time mix + channel mix.

Port of ``src/repro/models/rwkv6.py``. The reference stacks the blocks for ``lax.scan`` with ``jax.checkpoint``; the port keeps
one parameter dict per block in ``params["blocks"]`` (a list) and runs them
in a Python loop without layer recompute. Each block's WKV recurrence
keeps one state per ``nn.rwkv.CHUNK`` steps for its backward (see
``nn.rwkv``).

Serving carries O(1) state a layer (``init_caches``: the wkv matrix and the
token-shift rows, a list over the blocks); ``forward_tokens`` runs a
prefill or decode segment from it, uninstrumented, writing each layer's
state in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.norms import init_layernorm, layernorm
from repro_torch.nn.rwkv import (RwkvCfg, init_rwkv_cmix, init_rwkv_state,
                                 init_rwkv_tmix, rwkv_cmix, rwkv_tmix)


@dataclasses.dataclass(frozen=True)
class Rwkv6Config:
    name: str
    n_layers: int = 32
    d_model: int = 2560
    vocab: int = 65536
    d_ff: int = 8960
    dtype: str = "float32"
    max_cache_len: int = 0   # unused: O(1) state

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


def _block(p, x, tap: Tap, cfg: Rwkv6Config, state=None):
    h = layernorm(p["ln1"], x, tap=tap)
    x = x + rwkv_tmix(p["tmix"], h, tap=tap, cfg=cfg.rwkv_cfg, state=state)
    h = layernorm(p["ln2"], x, tap=tap)
    return x + rwkv_cmix(p["cmix"], h, tap=tap, cfg=cfg.rwkv_cfg,
                         state=state)


def _run(params, ids, tap: Tap, cfg: Rwkv6Config, states=None):
    """Embedding, the blocks (each from its state when ``states`` is
    given), the final norm and the head → logits."""
    x = embed(params["embed"], ids, tap=tap, cfg=cfg.vocab_cfg)
    x = layernorm(params["ln_in"], x, tap=tap)
    for i, p in enumerate(params["blocks"]):
        x = _block(p, x, tap, cfg, None if states is None else states[i])
    x = layernorm(params["ln_f"], x, tap=tap)
    return lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)


def loss_fn(params, batch, tap: Tap, *, cfg: Rwkv6Config):
    """Canonical instrumented loss: (loss_vec, aux)."""
    logits = _run(params, batch["ids"], tap, cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}


def init_caches(batch: int, cfg: Rwkv6Config, device=None):
    """One zero ``init_rwkv_state`` per block for ``batch`` slots on
    ``device`` (default CUDA): O(1) in the context length."""
    device = pm.resolve_device(device)
    return [init_rwkv_state(batch, cfg.rwkv_cfg, dtype=cfg.torch_dtype,
                            device=device) for _ in range(cfg.n_layers)]


def forward_tokens(params, batch, caches, cache_index, *, cfg: Rwkv6Config):
    """Prefill or decode from ``caches`` (``init_caches``), uninstrumented
    (``taps.NULL``, inference mode): batch["ids"] (B, s) → (logits (B, s,
    vocab), caches), the states written in place. ``cache_index`` is
    unused: the state carries the position."""
    with torch.inference_mode():
        logits = _run(params, batch["ids"], taps.NULL, cfg, states=caches)
    return logits, caches
