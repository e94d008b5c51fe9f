"""The port's LoRA sites against the JAX reference's.

LoRA units of the port (``nn.lora``): the ``LoraPair`` tree node, its init,
``attach`` → ``adapter_tree`` → ``merge_adapters``, frozen bases, and
``interop`` carrying the reference's pairs (stacked (L, d, r) factors of
``blocks`` split per layer) into the port and back.

``Tap.dense_batched`` (the multi-tenant per-example-weight matmul) against
the reference's on the same numpy inputs, through both engines: 2-D h (the
exact factorized stat) and 3-D h (the segmented estimator over example-id
segments), f32 at 1e-5, bf16 within 1e-2 of the largest |value| (as in
``tests/test_torch_mla.py``).

The LoRA-fied llama3.2-1b smoke step (``LoraCfg(rank=2, alpha=4.0)`` on the
default sites, as ``tests/test_lora_tenancy.py``'s verifier test) against
the reference's ``Engine.step`` at 1e-4: ``[Norms]``, ``[Clip(1.0),
Grads]`` and the token-granularity ``[Clip(2.0, "token"), Grads]``, with
the reference's parameters (B drawn non-zero from a numpy seed, so both
factors have gradients) carried over by ``interop``. Each adapter tap's
stat is held at 1e-5 against the reference's estimator on the same (H, Z̄)
the port's tap saw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import norms as jN
from repro.models import registry as jreg
from repro.nn import lora as jlora
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import norms as tN
from repro_torch.core import taps as tT
from repro_torch.models import registry
from repro_torch.nn import lora as tlora
from repro_torch.nn import param as pm
from repro_torch.nn.linear import linear

RTOL = 1e-5
STEP_RTOL = 1e-4
BF16_TOL = 1e-2
ARCH = "llama3.2-1b"
B, S = 3, 12
D, O, R = 6, 4, 2
ALPHA = 8.0
CPU = torch.device("cpu")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


def _close(got, want, rtol=STEP_RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _close_max(got, want, tol):
    """Elementwise within ``tol`` of the largest |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _as_reference(tree):
    """A ``params_to_numpy`` tree with the port's LoRA pairs rebuilt as the
    reference's ``LoraPair`` (a JAX pytree node)."""
    if isinstance(tree, dict):
        return {k: _as_reference(v) for k, v in tree.items()}
    if isinstance(tree, tlora.LoraPair):
        return jlora.LoraPair(tree.a, tree.b, tree.alpha)
    return tree


def _close_trees(port_tree, jax_tree, rtol=STEP_RTOL):
    """Leafwise, to ``rtol`` of the leaf's largest element; LoRA pairs
    carried back as the reference's so the paths line up."""
    got = _as_reference(interop.params_to_numpy(port_tree))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = flat_want[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# LoRA units
# ---------------------------------------------------------------------------

def test_lora_pair_is_a_tree_node():
    p = tlora.init_pair(_gen(), D, O, R, ALPHA, device=CPU, b_std=0.3)
    doubled = pm.tree_map(lambda l: 2 * l, p)
    assert isinstance(doubled, tlora.LoraPair)
    assert doubled.alpha == ALPHA and doubled.rank == R
    torch.testing.assert_close(doubled.a, 2 * p.a, rtol=0, atol=0)
    leaves, treedef = pm.tree_flatten({"site": p})
    assert len(leaves) == 2 and leaves[0] is p.a and leaves[1] is p.b
    back = pm.tree_unflatten(treedef, leaves)["site"]
    assert isinstance(back, tlora.LoraPair) and back.alpha == ALPHA
    assert pm.count_params({"site": p}) == D * R + R * O


def test_init_pair_shapes_and_zero_delta():
    p = tlora.init_pair(_gen(), D, O, R, ALPHA, device=CPU)
    assert p.a.shape == (D, R) and p.b.shape == (R, O)
    assert torch.count_nonzero(p.b) == 0
    # A ~ N(0, 1/√d_in): the draw's scale, from one large pair
    big = tlora.init_pair(_gen(1), 400, 3, 64, ALPHA, device=CPU)
    assert abs(big.a.std().item() - 400 ** -0.5) < 0.1 * 400 ** -0.5
    x = torch.randn(3, D, generator=_gen(2))
    assert torch.count_nonzero(tlora.delta(p, x, tap=pex.NULL)) == 0
    lead = tlora.init_pair(_gen(), D, O, R, ALPHA, device=CPU, lead=(5,),
                           b_std=0.1)
    assert lead.a.shape == (5, D, R) and lead.b.shape == (5, R, O)


def test_attach_adapter_tree_merge_roundtrip():
    w = pm.normal(_gen(), (D, O), torch.float32, CPU)
    params = {"blocks": [{"attn": {"wq": {"w": w}, "scale": torch.ones(D)},
                          "mlp": {"up": {"w": w}}} for _ in range(2)]}
    cfg = tlora.LoraCfg(rank=3, alpha=6.0, sites=("wq", "up"),
                        rank_overrides=(("up", 2),))
    out = tlora.attach(params, cfg, seed=11, device=CPU)
    wq0 = out["blocks"][0]["attn"]["wq"]["lora"]
    wq1 = out["blocks"][1]["attn"]["wq"]["lora"]
    up = out["blocks"][0]["mlp"]["up"]["lora"]
    assert wq0.a.shape == (D, 3) and up.a.shape == (D, 2)
    assert "lora" not in params["blocks"][0]["attn"]["wq"]
    # each layer's site draws from its own path's seed
    assert not torch.equal(wq0.a, wq1.a)
    # deterministic (crc32 path seeds, not hash())
    again = tlora.attach(params, cfg, seed=11, device=CPU)
    assert torch.equal(again["blocks"][1]["attn"]["wq"]["lora"].a, wq1.a)
    at = tlora.adapter_tree(out)
    assert set(at) == {f"blocks/{i}/{s}/lora" for i in range(2)
                       for s in ("attn/wq", "mlp/up")}
    bumped = {k: tlora.LoraPair(v.a, v.b, v.alpha + 1)
              if k.endswith("wq/lora") else v for k, v in at.items()}
    merged = tlora.merge_adapters(out, bumped)
    assert merged["blocks"][1]["attn"]["wq"]["lora"].alpha == cfg.alpha + 1
    assert out["blocks"][1]["attn"]["wq"]["lora"].alpha == cfg.alpha
    assert merged["blocks"][0]["mlp"]["up"]["lora"] is up


def test_frozen_base_gets_zero_grad():
    pair = tlora.init_pair(_gen(), D, O, R, ALPHA, device=CPU, b_std=0.4)
    p = {"w": pm.normal(_gen(3), (D, O), torch.float32, CPU),
         "b": torch.zeros(O), "lora": pair}
    leaves, treedef = pm.tree_flatten(p)
    leaves = [x.detach().requires_grad_() for x in leaves]
    q = pm.tree_unflatten(treedef, leaves)
    x = torch.randn(3, S, D, generator=_gen(4))
    y = torch.randn(3, S, O, generator=_gen(5))
    loss = torch.sum(torch.square(linear(q, x, tap=pex.NULL) - y))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    named = dict(zip(["b", "a", "lora_b", "w"], grads))
    assert named["w"] is None and named["b"] is None   # frozen: unused
    assert named["a"].abs().sum() > 0 and named["lora_b"].abs().sum() > 0


def _lora_setup():
    """The reference's LoRA-fied llama3.2-1b smoke params (B factors drawn
    non-zero from a numpy seed), the port's copy, both batches."""
    jspec = jreg.get(ARCH)
    jcfg = dataclasses.replace(jspec.smoke(),
                               lora=jlora.LoraCfg(rank=2, alpha=4.0))
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    rs = np.random.default_rng(9)

    def live_b(x):
        if isinstance(x, jlora.LoraPair):
            b = jnp.asarray(0.2 * rs.standard_normal(x.b.shape), x.b.dtype)
            return jlora.LoraPair(x.a, b, x.alpha)
        return x
    jparams = jax.tree_util.tree_map(
        live_b, jparams, is_leaf=lambda x: isinstance(x, jlora.LoraPair))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    spec = registry.get(ARCH)
    cfg = dataclasses.replace(spec.smoke(),
                              lora=tlora.LoraCfg(rank=2, alpha=4.0))
    return dict(
        jcfg=jcfg, jparams=jparams, np_params=np_params, cfg=cfg,
        params=interop.params_from_numpy(np_params, device="cpu"),
        jbatch=jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B),
                                     3),
        batch=registry.make_train_batch(spec, cfg,
                                        ShapeSpec("t", "train", S, B), 3,
                                        device="cpu"),
        jloss=jreg.make_loss_fn_v2(jspec, jcfg),
        loss=registry.make_loss_fn_v2(spec, cfg))


@pytest.fixture(scope="module")
def lora_setup():
    return _lora_setup()


def test_interop_carries_stacked_pairs_both_ways(lora_setup):
    st = lora_setup
    blocks = st["params"]["blocks"]
    assert len(blocks) == st["cfg"].n_layers
    wq = st["np_params"]["blocks"]["attn"]["wq"]["lora"]
    for i, layer in enumerate(blocks):
        pair = layer["attn"]["wq"]["lora"]
        assert isinstance(pair, tlora.LoraPair) and pair.alpha == 4.0
        np.testing.assert_array_equal(pair.a.numpy(), wq.a[i])
        np.testing.assert_array_equal(pair.b.numpy(), wq.b[i])
    assert len(tlora.adapter_tree(st["params"])) == 7 * len(blocks)
    back = interop.params_to_numpy(st["params"])
    down = back["blocks"]["mlp"]["down"]["lora"]
    assert isinstance(down, tlora.LoraPair) and down.alpha == 4.0
    flat_back = jax.tree_util.tree_leaves_with_path(_as_reference(back))
    flat_want = jax.tree_util.tree_leaves_with_path(st["np_params"])
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(a, b)


def test_port_init_attaches_adapters():
    spec = registry.get(ARCH)
    cfg = dataclasses.replace(spec.smoke(),
                              lora=tlora.LoraCfg(rank=2, alpha=4.0))
    params = registry.family_module(spec).init(cfg, _gen(0), device="cpu")
    plain = registry.family_module(spec).init(spec.smoke(), _gen(0),
                                              device="cpu")
    at = tlora.adapter_tree(params)
    assert len(at) == 7 * cfg.n_layers
    for pair in at.values():
        assert pair.rank == 2 and torch.count_nonzero(pair.b) == 0
    # the bases are drawn first, as without LoRA
    torch.testing.assert_close(params["blocks"][0]["attn"]["wq"]["w"],
                               plain["blocks"][0]["attn"]["wq"]["w"],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dense_batched against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("ndim", [2, 3])
def test_dense_batched_matches_reference(dt, ndim):
    jdt, tdt = DTYPES[dt]
    rs = np.random.default_rng(ndim)
    lead = (7,) if ndim == 2 else (7, S)
    x = rs.standard_normal(lead + (D,)).astype(np.float32)
    y = rs.standard_normal(lead + (O,)).astype(np.float32)
    w = (0.5 * rs.standard_normal((7, D, O))).astype(np.float32)

    def jloss(params, batch, tap):
        z = tap.dense_batched(batch["x"], params["w"])
        d = jnp.square(z.astype(jnp.float32) - batch["y"])
        return jnp.sum(d.reshape(d.shape[0], -1), axis=1), {}

    def tloss(params, batch, tap):
        z = tap.dense_batched(batch["x"], params["w"])
        d = torch.square(z.float() - batch["y"])
        return torch.sum(d.reshape(d.shape[0], -1), dim=1), {}

    j = jpex.Engine(jpex.PexSpec()).step(
        jloss, {"w": jnp.asarray(w, jdt)},
        {"x": jnp.asarray(x, jdt), "y": jnp.asarray(y)},
        [jpex.Norms(), jpex.Grads()])
    t = pex.Engine(pex.PexSpec()).step(
        tloss, {"w": _t(w, tdt)}, {"x": _t(x, tdt), "y": _t(y)},
        [pex.Norms(), pex.Grads()])
    if dt == "f32":
        _close(t.sq_norms, j.sq_norms, rtol=RTOL)
        _close(t.grads["w"], j.grads["w"], rtol=RTOL, atol=1e-5)
        _close(t.loss_vec, j.loss_vec, rtol=RTOL)
    else:
        _close_max(t.sq_norms, j.sq_norms, BF16_TOL)
        _close_max(t.grads["w"], j.grads["w"], BF16_TOL)
        _close_max(t.loss_vec, j.loss_vec, BF16_TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_dense_batched_token_and_segmented_routes(use_kernels):
    """Both routes of the 3-D example stat (the segmented kernel's plain
    version, the scan oracle) and the token stat against the reference's
    token layout."""
    rs = np.random.default_rng(5)
    x = rs.standard_normal((5, S, D)).astype(np.float32)
    y = rs.standard_normal((5, S, O)).astype(np.float32)
    w = (0.5 * rs.standard_normal((5, D, O))).astype(np.float32)

    def jloss(params, batch, tap):
        z = tap.dense_batched(batch["x"], params["w"])
        tok = tap.token_loss(jnp.sum(jnp.square(z - batch["y"]), axis=-1))
        return jnp.sum(tok, axis=1), {}

    def tloss(params, batch, tap):
        z = tap.dense_batched(batch["x"], params["w"])
        tok = tap.token_loss(torch.sum(torch.square(z - batch["y"]), -1))
        return torch.sum(tok, dim=1), {}

    spec = pex.PexSpec(use_kernels=use_kernels)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": _t(x), "y": _t(y)}
    for gran in ("example", "token"):
        j = jpex.Engine(jpex.PexSpec(), granularity=gran).step(
            jloss, {"w": jnp.asarray(w)}, jb, [jpex.Norms()])
        t = pex.Engine(spec, granularity=gran).step(
            tloss, {"w": _t(w)}, tb, [pex.Norms()])
        _close(t.sq_norms, j.sq_norms, rtol=RTOL)
    with pytest.raises(ValueError, match="dense_batched"):
        tT.TokenLayout(S).add_dense_batched(
            torch.zeros(5, S), _t(x[:, 0]), _t(y[:, 0]), 0, use_kernels)


# ---------------------------------------------------------------------------
# the LoRA-fied llama3.2-1b smoke step
# ---------------------------------------------------------------------------

STEPS = {
    "norms": ([jpex.Norms()], [pex.Norms()], "example"),
    "clip": ([jpex.Clip(1.0), jpex.Grads()], [pex.Clip(1.0), pex.Grads()],
             "example"),
    "token": ([jpex.Clip(2.0, granularity="token"), jpex.Grads()],
              [pex.Clip(2.0, granularity="token"), pex.Grads()], "token"),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_lora_llama_step_matches_reference(lora_setup, name, monkeypatch):
    st = lora_setup
    jc, tc, gran = STEPS[name]
    seen = []
    stat_dense = tN.stat_dense

    def recording(h, zbar, *a, **kw):
        out = stat_dense(h, zbar, *a, **kw)
        seen.append((h.detach().numpy().copy(),
                     zbar.detach().numpy().copy(), out.detach().numpy()))
        return out

    monkeypatch.setattr(tT.N, "stat_dense", recording)
    j = jpex.Engine(jpex.PexSpec(), granularity=gran).step(
        st["jloss"], st["jparams"], st["jbatch"], jc)
    t = pex.Engine(pex.PexSpec(), granularity=gran).step(
        st["loss"], st["params"], st["batch"], tc)
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    if name != "norms":
        _close(t.clip_coef, j.clip_coef)
        _close_trees(t.grads, j.grads)
        # the frozen bases get exactly zero
        for layer in t.grads["blocks"]:
            for site in ("wq", "wk", "wv", "wo"):
                assert torch.count_nonzero(layer["attn"][site]["w"]) == 0
            for site in ("up", "gate", "down"):
                assert torch.count_nonzero(layer["mlp"][site]["w"]) == 0
    if gran == "example":
        # 14 adapter taps a layer and the head, each stat against the
        # reference's estimator on the (H, Z̄) the port's tap saw
        r = st["cfg"].lora.rank
        assert len(seen) == 14 * st["cfg"].n_layers + 1
        thin = [s for s in seen if r in (s[0].shape[-1], s[1].shape[-1])]
        assert len(thin) == 14 * st["cfg"].n_layers
        for h, z, got in seen:
            want = jN.stat_dense(jnp.asarray(h), jnp.asarray(z))
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=1e-7)
