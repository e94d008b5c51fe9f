"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400, 16 experts top-2 (renormalized gates), vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct]

Port of ``src/repro/configs/phi35_moe.py`` (``full`` and ``smoke``; the
roofline probes and skip lists of the reference's ``ArchSpec`` are not
carried over)."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.moe import MoeCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="phi3.5-moe", n_layers=32, d_model=4096, vocab=32064,
        attn=AttnCfg(d_model=4096, n_heads=32, n_kv=8, head_dim=128,
                     rope_theta=10000.0),
        moe=MoeCfg(d_model=4096, d_ff=6400, n_experts=16, top_k=2,
                   renorm_topk=True, dispatch_groups=16),
        dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="phi3.5-moe-smoke", n_layers=2, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                     head_multiple=1),
        moe=MoeCfg(d_model=64, d_ff=96, n_experts=4, top_k=2,
                   renorm_topk=True),
        dtype="float32")


SPEC = ArchSpec(arch_id="phi3.5-moe", family="transformer", full=full,
                smoke=smoke)
