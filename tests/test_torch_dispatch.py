"""The port's dense dispatch against the reference's, and its Hopper prices.

``core.norms.pick_method(use_kernels=False)`` keeps the reference's logical
flop model (its ``use_pallas=False`` side) and must pick what the reference
picks. ``use_kernels=True`` prices the port's own kernels
(``kernels.ops.gram_cost`` / ``direct_cost``); its picks at llama3.2-1b's
launch shapes are pinned here, the LM head on gram among them. The head's
norm then comes from the gram route, and it must equal the reference's,
which forces the direct route, at f32 1e-5 on the smoke step.
"""
import jax
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import norms as jN
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import norms as tN
from repro_torch.kernels import ops as tops
from repro_torch.models import registry

SEQS = (1, 8, 64, 100, 512, 1024, 4096)
SHAPES = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
          (2048, 128256), (64, 128256), (4096, 16), (24, 40))
#: llama3.2-1b at S=512: (p_in, p_out) → the priced pick
LLAMA = {"wk/wv": ((2048, 512), "direct"), "wq/wo": ((2048, 2048), "gram"),
         "w1/w3": ((2048, 8192), "gram"), "w2": ((8192, 2048), "gram"),
         "head": ((2048, 128256), "gram")}


@pytest.mark.parametrize("s", SEQS)
def test_logical_pick_matches_reference(s):
    for p_in, p_out in SHAPES:
        assert tN.pick_method(s, p_in, p_out, use_kernels=False) == \
            jN.pick_method(s, p_in, p_out, use_pallas=False), (s, p_in, p_out)
        for m in ("gram", "direct"):
            assert tN.dense_cost(m, s, p_in, p_out) == \
                jN.dense_cost(m, s, p_in, p_out, use_pallas=False)


@pytest.mark.parametrize("p_in, p_out", SHAPES[:5])
def test_logical_crossover_matches_reference(p_in, p_out):
    assert tN.crossover_s(p_in, p_out) == jN.crossover_s(p_in, p_out)


@pytest.mark.parametrize("layer", sorted(LLAMA))
def test_priced_pick_at_llama_shapes(layer):
    """The picks the main path's launch counts follow (S=512): wk/wv on
    direct, every other layer and the LM head on gram."""
    (p_in, p_out), want = LLAMA[layer]
    assert tN.pick_method(512, p_in, p_out, use_kernels=True) == want


def test_priced_costs_are_device_seconds():
    """The priced costs are seconds per example: each kernel's work at its
    own tiles over its rate, floored by the bytes read once."""
    s, p_in, p_out = 512, 2048, 512
    g = tops.gram_cost(s, p_in, p_out)
    d = tops.direct_cost(s, p_in, p_out)
    assert g == pytest.approx(10 * 2.0 * 128 * 128 * (p_in + p_out + 1)
                              / tops.GRAM_FLOPS_PER_S)
    assert d == pytest.approx((2.0 * s * p_in * p_out + 2.0 * p_in * p_out)
                              / tops.DIRECT_FLOPS_PER_S)
    # 8 examples at wk/wv price at the measured launch times (~0.027 and
    # ~0.020 ms) from which the rates were taken
    assert 8 * g * 1e3 == pytest.approx(0.0268, rel=0.01)
    assert 8 * d * 1e3 == pytest.approx(0.0196, rel=0.01)
    # direct pays for its 128 x 256 tile: p_out = 16 costs as 256
    assert tops.direct_cost(s, 4096, 16) == tops.direct_cost(s, 4096, 256)
    # a tiny layer holds gram to its bytes; direct still pays a full tile
    floor = (2.0 * 4 * (8 + 8) + 4.0) / tops.HBM_BYTES_PER_S
    assert tops.gram_cost(4, 8, 8) == floor < tops.direct_cost(4, 8, 8)
    assert tN.pick_method(4, 8, 8, use_kernels=True) == "gram"
    with pytest.raises(ValueError, match="unknown method"):
        tN.dense_cost("factorized", s, p_in, p_out, use_kernels=True)


@pytest.mark.parametrize("p_in, p_out", SHAPES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_crossover_is_monotone_and_matches_the_pick(p_in, p_out,
                                                    use_kernels):
    """gram below the crossover, direct from it on, for every s tried."""
    x = tN.crossover_s(p_in, p_out, use_kernels=use_kernels)
    for s in sorted({1, 2, 63, 64, 65, 127, 128, 129, 512, 1000, 4096,
                     max(1, x - 1), x, x + 1, 2 * x}):
        want = "gram" if s < x else "direct"
        if s <= 1 << 16:
            assert tN.pick_method(s, p_in, p_out, use_kernels) == want, s


def test_stat_dense_auto_takes_the_route_price_list(monkeypatch):
    """``method="auto"`` prices the route it runs: the kernels' list with
    ``use_kernels``, the logical flops without."""
    calls = []
    monkeypatch.setattr(tops, "gram_norm",
                        lambda h, z: calls.append("gram") or
                        torch.zeros(h.shape[0]))
    monkeypatch.setattr(tops, "direct_norm",
                        lambda h, z: calls.append("direct") or
                        torch.zeros(h.shape[0]))
    # (96, 64 → 64): logical picks direct, the kernels' prices gram
    assert tN.pick_method(96, 64, 64) == "direct"
    assert tN.pick_method(96, 64, 64, use_kernels=True) == "gram"
    h, z = torch.ones(2, 96, 64), torch.ones(2, 96, 64)
    tN.stat_dense(h, z, use_kernels=True)
    assert calls == ["gram"]
    torch.testing.assert_close(tN.stat_dense(h, z, use_kernels=False),
                               tN.stat_gram(h, z), rtol=1e-6, atol=0.0)


def test_head_norm_through_gram_matches_reference_forced_direct(
        monkeypatch):
    """On the llama3.2-1b smoke step the port's head stat goes to the gram
    route (its priced pick), the reference's to direct (forced); the
    head's per-example norm agrees at f32 1e-5."""
    groups = ("attn", "mlp", "norm", "embed", "head")
    b, s = 3, 12
    jspec = jreg.get("llama3.2-1b")
    jcfg = jspec.smoke()
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", s, b), 3)
    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", s, b),
                                      3, device="cpu")
    routes = []
    for name in ("gram_norm", "direct_norm"):
        real = getattr(tops, name)

        def spy(h, z, real=real, name=name):
            routes.append((name, z.shape[-1]))
            return real(h, z)
        monkeypatch.setattr(tops, name, spy)
    j = jpex.Engine(jpex.PexSpec(groups=groups)).step(
        jreg.make_loss_fn_v2(jspec, jcfg), jparams, jbatch, [jpex.Norms()])
    t = pex.Engine(pex.PexSpec(groups=groups)).step(
        registry.make_loss_fn_v2(spec, cfg), params, batch, [pex.Norms()])
    vocab_p = params["head"]["w"].shape[1]
    assert ("gram_norm", vocab_p) in routes
    assert ("direct_norm", vocab_p) not in routes
    np.testing.assert_allclose(t.sq_norms[:, groups.index("head")].numpy(),
                               np.asarray(j.sq_norms)[:, groups.index("head")],
                               rtol=1e-5, atol=0.0)
