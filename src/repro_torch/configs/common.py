"""Shared config machinery: input shapes and the arch registry entry.

Port of ``ShapeSpec``, ``SHAPES`` and ``ArchSpec`` from
``src/repro/configs/common.py``. The TPU-mesh sharding rules and analytic
FLOP helpers are not carried over; the roofline probes are
``launch.probes``'s.
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


#: the reference's assigned input shapes (its ``configs.common.SHAPES``),
#: the cells of ``launch.dryrun`` and ``launch.probes``
SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass
class ArchSpec:
    """Registry entry binding a config family to model entry points."""
    arch_id: str
    family: str                      # transformer | rwkv6 | zamba2 | seamless
    full: Callable[..., object]      # exact published config
    smoke: Callable[[], object]      # reduced config for CPU smoke tests
