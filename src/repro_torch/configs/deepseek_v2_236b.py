"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512,
q_lora=1536, nope=128, rope=64, v=128) vocab=102400; MoE: 2 shared +
160 routed experts, top-6, d_ff(expert)=1536, routed scale 16; first layer
dense (d_ff=12288). [arXiv:2405.04434]

Port of ``src/repro/configs/deepseek_v2_236b.py`` (``full`` and ``smoke``;
the roofline probes, the microbatch count and the skip lists of the
reference's ``ArchSpec`` are not carried over). The reference's probe depth
2 is ``dataclasses.replace(full(), n_layers=2)``: the dense prefix layer
and one MoE layer."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.mla import MlaCfg
from repro_torch.nn.mlp import MlpCfg
from repro_torch.nn.moe import MoeCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, vocab=102400,
        mla=MlaCfg(d_model=5120, n_heads=128, q_lora=1536, kv_lora=512,
                   qk_nope=128, qk_rope=64, v_dim=128),
        moe=MoeCfg(d_model=5120, d_ff=1536, n_experts=160, top_k=6,
                   n_shared=2, routed_scale=16.0, dispatch_groups=16),
        n_dense_prefix=1,
        dense_prefix_mlp=MlpCfg(d_model=5120, d_ff=12288, act="silu"),
        dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b-smoke", n_layers=3, d_model=64, vocab=128,
        mla=MlaCfg(d_model=64, n_heads=4, q_lora=32, kv_lora=16,
                   qk_nope=16, qk_rope=8, v_dim=16),
        moe=MoeCfg(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=1,
                   routed_scale=1.0),
        n_dense_prefix=1,
        dense_prefix_mlp=MlpCfg(d_model=64, d_ff=128, act="silu"),
        dtype="float32")


SPEC = ArchSpec(arch_id="deepseek-v2-236b", family="transformer",
                full=full, smoke=smoke,
                # the reference's: two microbatches halve the activations
                train_microbatches=2)
