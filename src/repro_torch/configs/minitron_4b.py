"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron: squared-ReLU MLP, no gate.
[arXiv:2407.14679]

Port of ``src/repro/configs/minitron_4b.py`` (``full`` and ``smoke``). As
in the reference, the 24 Q heads are padded to 32."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="minitron-4b", n_layers=32, d_model=3072, vocab=256000,
        attn=AttnCfg(d_model=3072, n_heads=24, n_kv=8, head_dim=128,
                     rope_theta=10000.0),
        mlp=MlpCfg(d_model=3072, d_ff=9216, act="relu2", gated=False),
        dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="minitron-4b-smoke", n_layers=2, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=3, n_kv=1, head_dim=16,
                     head_multiple=2),  # exercises head padding (3→4)
        mlp=MlpCfg(d_model=64, d_ff=128, act="relu2", gated=False),
        dtype="float32")


SPEC = ArchSpec(arch_id="minitron-4b", family="transformer", full=full,
                smoke=smoke)
