"""Zamba2-7B: Mamba2 backbone + one *shared* full-attention block applied
every ``share_every`` layers on concat(h, h⁰) (the original embeddings).

Port of ``src/repro/models/zamba2.py``: ``n_groups``
groups of ``share_every`` mamba blocks, each group followed by the shared
block, then the ``n_tail`` tail blocks. The reference stacks the grouped
blocks on (G, K) axes and the tail on one; the port keeps
``params["blocks"]`` as a list of G lists of K per-block dicts and
``params["tail"]`` as a list (absent when there is no tail), and runs them
in Python loops, each mamba block of the groups and of the tail
checkpointed in training as the reference's are (``remat``, on by default:
``core.taps.checkpoint``, policy ``"full"``; the shared block is not).
Each SSM's recurrence keeps one
state per ``nn.ssm.CHUNK`` steps for its backward (see ``nn.ssm``).

Pex scope: the mamba blocks are tapped. The shared block's parameters are
reused at every group — the per-use rank factorization does not hold
across uses — so it runs with the inert ``taps.NULL``: its parameters get
gradients (summed over the uses), Clip's reweighting and noise, but no
stat, as in the reference (DESIGN.md §5).

Serving: ``init_caches`` gives every mamba block its SSM state (``states``:
``blocks`` as G lists of K, ``tail`` a list) and every use of the shared
block its own KV cache (``shared``: one per group), and ``forward_tokens``
runs a prefill or decode segment through them, uninstrumented, writing
them in place; x⁰ is the current tokens' embedding, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.dist.sharding import inference
from repro_torch.nn.attention import (AttnCfg, attention, init_attention,
                                      init_kv_cache)
from repro_torch.nn.embedding import (VocabCfg, embed, init_embedding,
                                      init_lm_head, lm_head, per_example_xent)
from repro_torch.nn.mlp import MlpCfg, init_mlp, mlp
from repro_torch.nn.norms import init_rmsnorm, rmsnorm
from repro_torch.nn.ssm import SsmCfg, init_ssm, init_ssm_state, ssm


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    name: str
    n_layers: int = 81
    d_model: int = 3584
    vocab: int = 32000
    d_ff: int = 14336
    n_heads: int = 32
    kv_heads: int = 32
    ssm: SsmCfg = dataclasses.field(
        default_factory=lambda: SsmCfg(d_model=3584, d_state=64))
    share_every: int = 6
    rms_eps: float = 1e-5
    dtype: str = "float32"
    remat: bool = True
    max_cache_len: int = 0                # set by serving_config

    @property
    def torch_dtype(self) -> torch.dtype:
        return pm.torch_dtype(self.dtype)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.share_every

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_groups * self.share_every

    @property
    def attn_cfg(self) -> AttnCfg:
        # attention over concat(h, h0): 2·d_model, out back to d_model
        return AttnCfg(d_model=2 * self.d_model, n_heads=self.n_heads,
                       n_kv=self.kv_heads,
                       head_dim=2 * self.d_model // self.n_heads,
                       d_out=self.d_model, rope_theta=10000.0)

    @property
    def mlp_cfg(self) -> MlpCfg:
        return MlpCfg(self.d_model, self.d_ff)

    @property
    def vocab_cfg(self) -> VocabCfg:
        return VocabCfg(self.vocab, self.d_model)


def _init_mamba_block(gen, cfg: Zamba2Config, kw):
    return {"ln": init_rmsnorm(cfg.d_model, **kw),
            "ssm": init_ssm(gen, cfg.ssm, **kw)}


def init(cfg: Zamba2Config, generator: torch.Generator, device=None):
    """Random parameters with the reference's distributions, drawn from
    ``generator`` on ``device`` (default CUDA)."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    params = {
        "embed": init_embedding(generator, cfg.vocab_cfg, **kw),
        "head": init_lm_head(generator, cfg.vocab_cfg, **kw),
        "ln_f": init_rmsnorm(cfg.d_model, **kw),
        "shared": {
            "ln": init_rmsnorm(2 * cfg.d_model, **kw),
            "attn": init_attention(generator, cfg.attn_cfg, **kw),
            "ln_mlp": init_rmsnorm(cfg.d_model, **kw),
            "mlp": init_mlp(generator, cfg.mlp_cfg, **kw),
        },
    }
    params["blocks"] = [[_init_mamba_block(generator, cfg, kw)
                         for _ in range(cfg.share_every)]
                        for _ in range(cfg.n_groups)]
    if cfg.n_tail:
        params["tail"] = [_init_mamba_block(generator, cfg, kw)
                          for _ in range(cfg.n_tail)]
    return params


def _mamba_block(p, x, tap: Tap, cfg: Zamba2Config, state=None):
    h = rmsnorm(p["ln"], x, tap=tap, eps=cfg.rms_eps)
    return x + ssm(p["ssm"], h, tap=tap, cfg=cfg.ssm, state=state)


def _shared_block(p, x, x0, cfg: Zamba2Config, *, cache=None,
                  cache_index=None):
    """Shared attention + MLP on concat(h, h0), pex-excluded: the inert tap
    (weight reuse breaks the per-use rank factorization, DESIGN.md §5)."""
    tap = taps.NULL
    cat = torch.cat([x, x0], dim=-1)
    h = rmsnorm(p["ln"], cat, tap=tap, eps=cfg.rms_eps)
    x = x + attention(p["attn"], h, tap=tap, cfg=cfg.attn_cfg, cache=cache,
                      cache_index=cache_index)
    h = rmsnorm(p["ln_mlp"], x, tap=tap, eps=cfg.rms_eps)
    return x + mlp(p["mlp"], h, tap=tap, cfg=cfg.mlp_cfg)


def _run(params, ids, tap: Tap, cfg: Zamba2Config, caches=None,
         cache_index=None):
    """Embedding, the groups (each followed by the shared block), the
    tail, the final norm and the head → logits; every block and use of
    the shared block with its state or cache when ``caches`` is given;
    without caches each mamba block is checkpointed under ``cfg.remat``."""
    x = embed(params["embed"], ids, tap=tap, cfg=cfg.vocab_cfg)
    x0 = x
    block = _mamba_block
    if cfg.remat and caches is None:
        block = taps.checkpoint(_mamba_block, tap=tap)
    for g, group in enumerate(params["blocks"]):
        for i, p in enumerate(group):
            st = None if caches is None else caches["states"]["blocks"][g][i]
            x = block(p, x, tap, cfg, st)
        x = _shared_block(params["shared"], x, x0, cfg,
                          cache=None if caches is None
                          else caches["shared"][g], cache_index=cache_index)
    for i, p in enumerate(params.get("tail", [])):
        st = None if caches is None else caches["states"]["tail"][i]
        x = block(p, x, tap, cfg, st)
    x = rmsnorm(params["ln_f"], x, tap=tap, eps=cfg.rms_eps)
    return lm_head(params["head"], x, tap=tap, cfg=cfg.vocab_cfg)


def remat_blocks(cfg: Zamba2Config) -> int:
    """Blocks ``_run`` checkpoints in a training step (no caches), each
    re-run once in every backward: every mamba block of the groups and
    the tail, not the shared block."""
    return cfg.n_groups * cfg.share_every + cfg.n_tail if cfg.remat else 0


def loss_fn(params, batch, tap: Tap, *, cfg: Zamba2Config):
    """Canonical instrumented loss: (loss_vec, aux)."""
    logits = _run(params, batch["ids"], tap, cfg)
    loss_vec = per_example_xent(logits, batch["labels"],
                                batch.get("label_mask"), tap=tap)
    return loss_vec, {}


def init_caches(batch: int, cfg: Zamba2Config, device=None):
    """Zero serving state for ``batch`` slots on ``device`` (default CUDA):
    ``{"states": {"blocks": G lists of K ``init_ssm_state``, "tail": a list
    (None without a tail)}, "shared": G ``init_kv_cache`` of
    ``max_cache_len`` rows}``."""
    device = pm.resolve_device(device)
    kw = dict(dtype=cfg.torch_dtype, device=device)

    def st():
        return init_ssm_state(batch, cfg.ssm, **kw)
    return {"states": {"blocks": [[st() for _ in range(cfg.share_every)]
                                  for _ in range(cfg.n_groups)],
                       "tail": [st() for _ in range(cfg.n_tail)]
                       if cfg.n_tail else None},
            "shared": [init_kv_cache(batch, cfg.max_cache_len, cfg.attn_cfg,
                                     **kw) for _ in range(cfg.n_groups)]}


def forward_tokens(params, batch, caches, cache_index, *,
                   cfg: Zamba2Config):
    """Prefill or decode from ``caches`` (``init_caches``) at
    ``cache_index``, uninstrumented (``taps.NULL``, inference mode):
    batch["ids"] (B, s) → (logits (B, s, vocab), caches), written in
    place."""
    with inference(params):
        logits = _run(params, batch["ids"], taps.NULL, cfg, caches,
                      cache_index)
    return logits, caches
