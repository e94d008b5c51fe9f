"""seamless-m4t-medium [audio]: 12L(enc)+12L(dec) d_model=1024 16H
d_ff=4096 vocab=256206 — enc-dec; audio frontend stubbed (precomputed
frame embeddings, the batch's ``src_frames``). [arXiv:2308.11596]

Port of ``src/repro/configs/seamless_m4t_medium.py`` (``full`` and
``smoke``; the roofline probes, ``combine`` and the skip list are not
carried over). vocab 256206 pads to 256208 (÷16)."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.seamless import SeamlessConfig


def full(dtype="bfloat16") -> SeamlessConfig:
    return SeamlessConfig(name="seamless-m4t-medium", n_enc=12, n_dec=12,
                          d_model=1024, n_heads=16, kv_heads=16,
                          d_ff=4096, vocab=256206, dtype=dtype)


def smoke() -> SeamlessConfig:
    return SeamlessConfig(name="seamless-m4t-medium-smoke", n_enc=2,
                          n_dec=2, d_model=64, n_heads=4, kv_heads=4,
                          d_ff=128, vocab=131, dtype="float32")


SPEC = ArchSpec(arch_id="seamless-m4t-medium", family="seamless", full=full,
                smoke=smoke)
