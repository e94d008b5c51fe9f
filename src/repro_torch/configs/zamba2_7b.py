"""zamba2-7b [hybrid]: 81L d_model=3584 Mamba2 (ssm_state=64) + one
shared attention block (32H, d_ff=14336) applied every 6 layers on
concat(h, h⁰), vocab=32000. [arXiv:2411.15242]

Port of ``src/repro/configs/zamba2_7b.py`` (``full`` and ``smoke``; the
roofline probes and ``combine`` are not carried over). The reference's
probe depths are 6 (one group), 12 (two groups) and 9 (one group of 6,
the shared block once, 3 tail blocks): ``dataclasses.replace(full(),
n_layers=9)``. The shared block's parameters are outside the pex norm
scope (weight reuse breaks the per-use rank factorization, DESIGN.md
§5)."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.zamba2 import Zamba2Config
from repro_torch.nn.ssm import SsmCfg


def full(dtype="bfloat16") -> Zamba2Config:
    return Zamba2Config(name="zamba2-7b", n_layers=81, d_model=3584,
                        vocab=32000, d_ff=14336, n_heads=32, kv_heads=32,
                        ssm=SsmCfg(d_model=3584, d_state=64),
                        share_every=6, dtype=dtype)


def smoke() -> Zamba2Config:
    return Zamba2Config(name="zamba2-7b-smoke", n_layers=5, d_model=64,
                        vocab=128, d_ff=128, n_heads=4, kv_heads=4,
                        ssm=SsmCfg(d_model=64, d_state=8, head_dim=16),
                        share_every=2, dtype="float32")


SPEC = ArchSpec(arch_id="zamba2-7b", family="zamba2", full=full, smoke=smoke)
