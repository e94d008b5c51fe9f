"""Arch registry: ``get(arch_id)`` resolves here.

Port of the subset of ``src/repro/models/registry.py`` the port needs so
far: ``get``, ``family_module``, ``make_loss_fn_v2`` and
``make_train_batch``. The transformer family's archs are registered:
llama3.2-1b, qwen2-7b, qwen2-vl-7b, minitron-4b, gemma2-9b, phi3.5-moe
and deepseek-v2-236b (MLA, a dense prefix layer, shared and routed
experts). The other families, serving and the input-spec builders of the
dry run come in later slices.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs import (deepseek_v2_236b, gemma2_9b, llama3_2_1b,
                                 minitron_4b, phi35_moe, qwen2_7b,
                                 qwen2_vl_7b)
from repro_torch.configs.common import ArchSpec, ShapeSpec
from repro_torch.models import transformer
from repro_torch.nn.param import resolve_device

ARCHS: Dict[str, ArchSpec] = {s.arch_id: s for s in [
    llama3_2_1b.SPEC, qwen2_7b.SPEC, qwen2_vl_7b.SPEC, minitron_4b.SPEC,
    gemma2_9b.SPEC, phi35_moe.SPEC, deepseek_v2_236b.SPEC]}

_FAMILIES = {"transformer": transformer}


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
    if cfg.vl_inputs:
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
