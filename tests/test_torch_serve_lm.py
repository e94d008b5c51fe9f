"""Serving on the transformer family against the JAX reference: the seven
archs llama3.2-1b, qwen2-7b, qwen2-vl-7b (prefilled with its visual embeds
and (B, 3, S) M-RoPE positions, decoded on the text-only fallback),
minitron-4b, gemma2-9b (local and global layers, softcaps), phi3.5-moe and
deepseek-v2-236b (the MLA latent cache in its absorbed form, the dense
prefix). For each: the port's prefill and every decode step against the
reference's ``forward_tokens`` (MoE archs at their own capacity, drops
and all, as served), one decode step from the reference's own caches
carried by ``interop``, and the port's prefill + decode against its own
full forward. Checks and tolerances in ``tests/torch_serve_parity.py``.
"""
import pytest

import torch_serve_parity as sp

ARCHS = ["llama3.2-1b", "qwen2-7b", "qwen2-vl-7b", "minitron-4b",
         "gemma2-9b", "phi3.5-moe", "deepseek-v2-236b"]


@pytest.fixture(scope="module", params=ARCHS)
def st(request):
    return sp.setup(request.param)


def test_prefill_and_every_decode_step_match_reference(st):
    sp.decode_matches_reference(st)


def test_decode_step_from_reference_cache_matches(st):
    sp.decode_from_reference_cache(st)


def test_prefill_decode_matches_own_full_forward(st):
    sp.decode_matches_own_full_forward(st)
