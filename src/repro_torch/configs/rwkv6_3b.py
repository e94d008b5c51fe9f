"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892]

Port of ``src/repro/configs/rwkv6_3b.py`` (``full`` and ``smoke``; the
roofline probes and ``combine`` of the reference's ``ArchSpec`` are not
carried over). The reference's probe depths are 1 and 2:
``dataclasses.replace(full(), n_layers=2)``."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.rwkv6 import Rwkv6Config


def full(dtype="bfloat16") -> Rwkv6Config:
    return Rwkv6Config(name="rwkv6-3b", n_layers=32, d_model=2560,
                       vocab=65536, d_ff=8960, dtype=dtype)


def smoke() -> Rwkv6Config:
    return Rwkv6Config(name="rwkv6-3b-smoke", n_layers=2, d_model=64,
                       vocab=128, d_ff=128, dtype="float32")


SPEC = ArchSpec(arch_id="rwkv6-3b", family="rwkv6", full=full, smoke=smoke)
