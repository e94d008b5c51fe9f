"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B]

Port of ``src/repro/configs/llama3_2_1b.py``. As in the reference, the
embedding and LM head are untied (tied weights couple per-example Gram
terms across the two uses)."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, vocab=128256,
        attn=AttnCfg(d_model=2048, n_heads=32, n_kv=8, head_dim=64,
                     rope_theta=500000.0),
        mlp=MlpCfg(d_model=2048, d_ff=8192, act="silu"),
        dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="llama3.2-1b-smoke", n_layers=2, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                     head_multiple=1),
        mlp=MlpCfg(d_model=64, d_ff=128, act="silu"),
        dtype="float32")


SPEC = ArchSpec(arch_id="llama3.2-1b", family="transformer", full=full,
                smoke=smoke)
