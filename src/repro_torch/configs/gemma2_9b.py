"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — alternating local(4096)/global attention, attn softcap
50, final logit softcap 30, sandwich RMSNorms, (1+g) scales, embeds ×√d,
query scale 256^-1/2. [arXiv:2408.00118]

Port of ``src/repro/configs/gemma2_9b.py`` (``full`` and ``smoke``). Its
local/global pattern has period 2, so a depth cut keeps whole periods."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg


def full(dtype="bfloat16") -> LMConfig:
    return LMConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, vocab=256000,
        attn=AttnCfg(d_model=3584, n_heads=16, n_kv=8, head_dim=256,
                     softcap=50.0, window=4096, rope_theta=10000.0,
                     attn_scale=256.0 ** -0.5),
        mlp=MlpCfg(d_model=3584, d_ff=14336, act="gelu"),
        rms_plus_one=True, post_norms=True, alt_local_global=True,
        logit_softcap=30.0, scale_embeds=True, dtype=dtype)


def smoke() -> LMConfig:
    return LMConfig(
        name="gemma2-9b-smoke", n_layers=4, d_model=64, vocab=128,
        attn=AttnCfg(d_model=64, n_heads=4, n_kv=2, head_dim=16,
                     softcap=50.0, window=8, head_multiple=1,
                     attn_scale=16.0 ** -0.5),
        mlp=MlpCfg(d_model=64, d_ff=128, act="gelu"),
        rms_plus_one=True, post_norms=True, alt_local_global=True,
        logit_softcap=30.0, scale_embeds=True, dtype="float32")


SPEC = ArchSpec(arch_id="gemma2-9b", family="transformer", full=full,
                smoke=smoke)
