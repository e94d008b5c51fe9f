"""Shared config machinery: input shapes and the arch registry entry.

Port of ``ShapeSpec`` and ``ArchSpec`` from ``src/repro/configs/common.py``.
The TPU-mesh sharding rules, roofline probes and analytic FLOP helpers are
not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


@dataclasses.dataclass
class ArchSpec:
    """Registry entry binding a config family to model entry points."""
    arch_id: str
    family: str                      # transformer | rwkv6 | zamba2 | seamless
    full: Callable[..., object]      # exact published config
    smoke: Callable[[], object]      # reduced config for CPU smoke tests
