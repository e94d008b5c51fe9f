"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671]

Port of ``src/repro/configs/qwen2_7b.py`` (``full`` and ``smoke``). As in
the reference, the 28 Q heads are padded to 32 (zero-init pad rows, so
every stat is exact)."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, vocab=152064,
        attn=AttnCfg(d_model=3584, n_heads=28, n_kv=4, head_dim=128,
                     bias=True, rope_theta=1000000.0),
        mlp=MlpCfg(d_model=3584, d_ff=18944, act="silu"),
        dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-7b-smoke", n_layers=2, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=7, n_kv=1, head_dim=8, bias=True,
                     head_multiple=4),  # exercises head padding (7→8)
        mlp=MlpCfg(d_model=64, d_ff=160, act="silu"),
        dtype="float32")


SPEC = ArchSpec(arch_id="qwen2-7b", family="transformer", full=full,
                smoke=smoke)
