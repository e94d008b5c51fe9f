"""Serving on the other families against the JAX reference: rwkv6-3b (the
O(1) wkv and token-shift state), zamba2-7b (SSM states, conv histories and
the shared block's per-use KV caches) and seamless-m4t-medium (prefilled
from ``src_frames``: the encoder memory and every decoder layer's cross
K/V; decoded against them). For each: the port's prefill and every decode
step against the reference's ``forward_tokens``, one decode step from the
reference's caches carried by ``interop``, and the port's prefill + decode
against its own full forward (checks and tolerances in
``tests/torch_serve_parity.py``); then rwkv6's state is O(1) in the
context, and a two-segment prefill (5 + rest) of rwkv6 and zamba2 gives
the one-shot logits (``tests/test_train_serve_integration.py``'s
property, at its 2e-3), and zamba2's gap there is no larger than the
reference's on the same parameters and tokens (at ``chip_smoke.py``
phase 33's B=2, S=32 and seed 0, at smoke width).
"""
import pytest
import torch

import torch_serve_parity as sp
from repro_torch.configs.common import ShapeSpec
from repro_torch.models import registry

ARCHS = ["rwkv6-3b", "zamba2-7b", "seamless-m4t-medium"]


@pytest.fixture(scope="module", params=ARCHS)
def st(request):
    return sp.setup(request.param)


def test_prefill_and_every_decode_step_match_reference(st):
    sp.decode_matches_reference(st)


def test_decode_step_from_reference_cache_matches(st):
    sp.decode_from_reference_cache(st)


def test_prefill_decode_matches_own_full_forward(st):
    sp.decode_matches_own_full_forward(st)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_two_segment_prefill_matches_one_shot(arch):
    st = sp.setup(arch)
    cfg, params, batch, mod = st["cfg"], st["params"], st["batch"], st["mod"]
    ids = batch["ids"]
    whole, _ = st["fwd"](params, {"ids": ids},
                         mod.init_caches(sp.B, cfg, device="cpu"), 0)
    c = mod.init_caches(sp.B, cfg, device="cpu")
    _, c = st["fwd"](params, {"ids": ids[:, :5]}, c, 0)
    rest, _ = st["fwd"](params, {"ids": ids[:, 5:]}, c, 5)
    sp.close(rest[..., :cfg.vocab], whole[:, 5:, :cfg.vocab].numpy(),
             sp.OWN_TOL)


def test_zamba2_two_segment_gap_no_larger_than_reference():
    """Phase 33's two-segment gap on the card (2.537e-4, f32, 9 layers at
    full width) is not the port's own: at smoke width on the same inputs
    its gap is within the reference's."""
    from repro.configs.common import ShapeSpec as JShape
    b, s = 2, 32
    spec, jspec = registry.get("zamba2-7b"), sp.jreg.get("zamba2-7b")
    cfg = registry.serving_config(spec, spec.smoke(),
                                  ShapeSpec("t", "decode", s, b))
    jcfg = sp.jreg.serving_config(jspec, jspec.smoke(),
                                  JShape("t", "decode", s, b))
    port, ref = sp.two_segment_gaps("zamba2-7b", cfg, jcfg, b, s)
    assert 0 < ref < sp.OWN_TOL
    assert port <= ref, (port, ref)


def test_rwkv_state_is_o1():
    """rwkv6's caches hold no axis that grows with the context: the same
    shapes at 16 and at 4096 cache rows."""
    spec = registry.get("rwkv6-3b")
    shapes = []
    for n in (16, 4096):
        cfg = registry.serving_config(spec, spec.smoke(),
                                      ShapeSpec("t", "decode", n, 2))
        caches = registry.family_module(spec).init_caches(2, cfg,
                                                          device="cpu")
        shapes.append([{k: tuple(v.shape) for k, v in c.items()}
                       for c in caches])
        assert all(n not in s for c in shapes[-1] for s in c.values())
    assert shapes[0] == shapes[1]
    assert {k: v.dtype for k, v in caches[0].items()} == {
        "tm_shift": torch.float32, "cm_shift": torch.float32,
        "wkv": torch.float32}
