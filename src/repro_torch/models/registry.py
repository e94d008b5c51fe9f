"""Arch registry: ``get(arch_id)`` resolves here.

Port of ``src/repro/models/registry.py``: ``get``, ``family_module``,
``make_loss_fn_v2``, ``make_forward_tokens``, ``serving_config``,
``make_train_batch``, the declared untapped scope (``UNTAPPED_ALLOWLIST``)
and ``rules_for``, the logical→mesh rules of one (arch × shape × mesh)
cell. All ten archs are registered: the transformer family's llama3.2-1b,
qwen2-7b, qwen2-vl-7b, minitron-4b, gemma2-9b, phi3.5-moe and
deepseek-v2-236b, and rwkv6-3b, zamba2-7b and seamless-m4t-medium. The
dry run's input specs are ``launch.dryrun``'s (on ``meta`` tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import (deepseek_v2_236b, gemma2_9b, llama3_2_1b,
                                 minitron_4b, phi35_moe, qwen2_7b,
                                 qwen2_vl_7b, rwkv6_3b, seamless_m4t_medium,
                                 zamba2_7b)
from repro_torch.configs.common import ArchSpec, ShapeSpec, base_rules
from repro_torch.models import rwkv6, seamless, transformer, zamba2
from repro_torch.nn.param import resolve_device, tree_paths

ARCHS: Dict[str, ArchSpec] = {s.arch_id: s for s in [
    llama3_2_1b.SPEC, qwen2_7b.SPEC, qwen2_vl_7b.SPEC, minitron_4b.SPEC,
    gemma2_9b.SPEC, phi35_moe.SPEC, deepseek_v2_236b.SPEC, rwkv6_3b.SPEC,
    zamba2_7b.SPEC, seamless_m4t_medium.SPEC]}

_FAMILIES = {"transformer": transformer, "rwkv6": rwkv6, "zamba2": zamba2,
             "seamless": seamless}

#: Parameters *intentionally* outside the pex norm scope, per arch: the
#: port's copy of the reference's table (``src/repro/models/registry.py``,
#: DESIGN.md §5), written for the port's key paths, where a layer is a list
#: index and not a stacked axis. Each entry is a dict key; a leaf is out of
#: scope when any key on its path is one of its arch's entries. zamba2: the
#: weight-shared block runs with ``taps.NULL``, and the SSM's conv and decay
#: tensors (conv_w, conv_b, a_log, d) take non-matmul gradient paths;
#: rwkv6: the token/channel-mix interpolation bases (mu), the decay base
#: (w0) and the bonus (u) likewise. They are trained (gradients, Clip's
#: reweighting, noise) but give no stat.
UNTAPPED_ALLOWLIST: Dict[str, tuple] = {
    "zamba2-7b": ("shared", "a_log", "d", "conv_w", "conv_b"),
    "rwkv6-3b": ("mu", "w0", "u"),
}


def untapped_allowlist(arch_id: str) -> tuple:
    """Declared intentionally-untapped keys for an arch."""
    return UNTAPPED_ALLOWLIST.get(arch_id, ())


def scope_mask(arch_id: str, params) -> list:
    """One bool per leaf of ``params``, in ``tree_leaves`` order: True where
    the leaf is in the pex norm scope (no key on its path is in the arch's
    ``untapped_allowlist``)."""
    excl = set(untapped_allowlist(arch_id))
    return [not excl.intersection(p) for p in tree_paths(params)]


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def family_module(spec: ArchSpec):
    return _FAMILIES[spec.family]


def make_loss_fn_v2(spec: ArchSpec, cfg):
    """Canonical loss for an arch: ``loss_fn(params, batch, tap) ->
    (loss_vec, aux)``."""
    mod = family_module(spec)

    def loss_fn(params, batch, tap):
        return mod.loss_fn(params, batch, tap, cfg=cfg)
    return loss_fn


def make_forward_tokens(spec: ArchSpec, cfg):
    """Serving entry point of an arch: ``fwd(params, batch, caches,
    cache_index) -> (logits, caches)``, the family's ``forward_tokens``
    (caches written in place)."""
    mod = family_module(spec)

    def fwd(params, batch, caches, cache_index):
        return mod.forward_tokens(params, batch, caches, cache_index, cfg=cfg)
    return fwd


def serving_config(spec: ArchSpec, cfg, shape: ShapeSpec):
    """``cfg`` with the cache lengths of a serve shape: ``max_cache_len``
    (and seamless's ``max_src_len``) = ``shape.seq``, and remat off."""
    kw = {"max_cache_len": shape.seq, "remat": False}
    if spec.family == "seamless":
        kw["max_src_len"] = shape.seq
    return dataclasses.replace(cfg, **kw)


def make_train_batch(spec: ArchSpec, cfg, shape: ShapeSpec, rng_seed=0,
                     device=None):
    """Synthetic batch from numpy ``default_rng(rng_seed)``, drawn as the
    reference draws it (the same arrays for the same seed), on ``device``
    (default CUDA): ids and labels, then for a config with ``vl_inputs``
    the visual embeds (B, S, d_model) in the config's dtype, the visual
    mask (the first half of each stream) and (B, 3, S) M-RoPE positions
    (the text arange on all three streams)."""
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    b, s = shape.batch, shape.seq
    ids = rng.integers(0, cfg.vocab, (b, s))
    labels = rng.integers(0, cfg.vocab, (b, s))
    batch = {"ids": torch.as_tensor(ids, dtype=torch.long, device=device),
             "labels": torch.as_tensor(labels, dtype=torch.long,
                                       device=device)}
    if spec.family == "seamless":
        frames = rng.normal(size=(b, s, cfg.d_model)) * 0.1
        batch["src_frames"] = torch.as_tensor(frames, device=device).to(
            cfg.torch_dtype)
    if getattr(cfg, "vl_inputs", False):
        vis = rng.normal(size=(b, s, cfg.d_model)) * 0.1
        batch["vis_embeds"] = torch.as_tensor(vis, device=device).to(
            cfg.torch_dtype)
        vm = np.zeros((b, s), bool)
        vm[:, : s // 2] = True  # first half of the stream is visual
        batch["vis_mask"] = torch.as_tensor(vm, device=device)
        pos = np.broadcast_to(np.arange(s), (b, 3, s))
        batch["positions"] = torch.as_tensor(pos.copy(), dtype=torch.long,
                                             device=device)
    return batch


def rules_for(spec: ArchSpec, cfg, shape: ShapeSpec, multi_pod: bool,
              model_size: int = 16, data_size: int = 16) -> dict:
    """Logical→mesh rules for one cell, as the reference's: KV heads go
    over the model axis only where they divide it (the transformer
    family's GQA heads, zamba2's shared attention), the batch over the
    data axes only where it divides them, and a 500k-token decode puts
    the KV sequence over data."""
    kv_shardable = True
    if spec.family == "transformer" and cfg.attn is not None:
        kv_shardable = cfg.attn.n_kv % model_size == 0
    if spec.family == "zamba2":
        kv_shardable = cfg.kv_heads % model_size == 0
    dp = data_size * (2 if multi_pod else 1)
    batch_shard = shape.batch % dp == 0
    return base_rules(multi_pod, kv_shardable=kv_shardable,
                      batch_shard=batch_shard,
                      seq_to_data=(shape.name == "long_500k"))
