"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191]

Port of ``src/repro/configs/qwen2_vl_7b.py`` (``full`` and ``smoke``).
Backbone only, as in the reference: the vision frontend is a stub, and
the batch supplies pre-merged visual embeddings, a visual-token mask and
(B, 3, S) M-RoPE position streams (``models.registry.make_train_batch``).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="qwen2-vl-7b", n_layers=28, d_model=3584, vocab=152064,
        attn=AttnCfg(d_model=3584, n_heads=28, n_kv=4, head_dim=128,
                     bias=True, rope_theta=1000000.0,
                     mrope_sections=(16, 24, 24)),
        mlp=MlpCfg(d_model=3584, d_ff=18944, act="silu"),
        vl_inputs=True, dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-7b-smoke", n_layers=2, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=4, n_kv=2, head_dim=16, bias=True,
                     head_multiple=1, mrope_sections=(2, 3, 3)),
        mlp=MlpCfg(d_model=64, d_ff=128, act="silu"),
        vl_inputs=True, dtype="float32")


SPEC = ArchSpec(arch_id="qwen2-vl-7b", family="transformer", full=full,
                smoke=smoke)
