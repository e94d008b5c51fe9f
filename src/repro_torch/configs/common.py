"""Shared config machinery: input shapes, the arch registry entry and the
logical→mesh sharding rules.

Port of ``ShapeSpec``, ``SHAPES``, ``ArchSpec`` and ``base_rules`` from
``src/repro/configs/common.py``. The rules map the logical axes the
parameters carry (``nn.param.axes_of``) and the activations name
(``dist.sharding.shard``) onto a ("data", "model") or ("pod", "data",
"model") mesh: FSDP puts the parameters' ``embed`` dim over the data axes,
tensor parallelism ``heads``, ``kv_heads``, ``mlp`` and ``vocab`` over
``model``, expert parallelism ``experts`` over ``model``. The analytic
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
    train_microbatches: int = 1      # gradient accumulation at train_4k


def base_rules(multi_pod: bool, *, kv_shardable: bool,
               batch_shard: bool = True, seq_to_data: bool = False) -> dict:
    """Logical→mesh axis rules shared by the arch configs (the
    reference's, entry for entry)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp if batch_shard else None,
        "embed": dp,                 # FSDP: params' d_model dim over data
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model" if kv_shardable else None,
        "vocab": "model",
        "experts": "model",
        "capacity": None,
        "moe_groups": dp,
        "expert_ff": None,
        "qlora": None,
        "kvlora": None,
        "embed2": None,
        "heads_act": "model",
        "kv_heads_act": "model" if kv_shardable else None,
        "mlp_act": "model",
        "vocab_act": "model",
        "embed_act": None,
        "seq_kv": ("data",) if seq_to_data else None,
    }
