"""Arch registry: ``get(arch_id)`` resolves here.

Port of the subset of ``src/repro/models/registry.py`` the port needs so
far: ``get``, ``family_module``, ``make_loss_fn_v2`` and
``make_train_batch``. llama3.2-1b and phi3.5-moe are registered; the other
configs and families, serving and the input-spec builders of the dry run
come in later slices.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs import llama3_2_1b, phi35_moe
from repro_torch.configs.common import ArchSpec, ShapeSpec
from repro_torch.models import transformer
from repro_torch.nn.param import resolve_device

ARCHS: Dict[str, ArchSpec] = {s.arch_id: s for s in [llama3_2_1b.SPEC,
                                                      phi35_moe.SPEC]}

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
    reference draws it (the same ids and labels for the same seed), on
    ``device`` (default CUDA)."""
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    b, s = shape.batch, shape.seq
    ids = rng.integers(0, cfg.vocab, (b, s))
    labels = rng.integers(0, cfg.vocab, (b, s))
    return {"ids": torch.as_tensor(ids, dtype=torch.long, device=device),
            "labels": torch.as_tensor(labels, dtype=torch.long,
                                      device=device)}
