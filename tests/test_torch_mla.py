"""The port's MLA and deepseek-v2-236b against the JAX reference's.

``nn.mla.mla_attention`` (the expanded train/prefill form) is held on the
same numpy inputs and the reference's ``init_mla`` parameters: its output,
and each of its seven taps' per-example stats — the five dense taps
(q_down, q_up, kv_down, kv_up, wo) and the q_norm / kv_norm scale taps —
as columns of an ``Engine.step([Norms()])`` whose ``PexSpec.groups`` name
one column per tap (both packages' ``linear`` and ``rmsnorm`` are given
the parameter's name as the group). f32 at 1e-5, bf16 within 1e-2 of the
largest |value| (as in ``tests/test_torch_archs.py``).

The deepseek-v2-236b smoke step (MLA, a dense prefix layer, shared and
routed experts) matches the reference's ``Engine.step`` at 1e-4: loss_vec,
per-example norms, clip coefficients and the clipped gradients, on three
variants: the smoke config; with ``routed_scale=16.0`` and
``n_shared=2``, where both bind (the smoke's 1.0 and 1 would hide a missing
scale or a shared expert); and with those and ``dispatch_groups=2,
capacity_factor=0.5``, where tokens drop. The norms are also held
against the batched-graph oracle (example j's gradient of one batched
forward, since capacity couples the examples of a group), and the summed
gradients against the batch backward. The ``prefix``
layer list carries over through ``interop`` both ways, and a decode cache
raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn import mla as jmla
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import taps as tT
from repro_torch.models import registry
from repro_torch.nn import mla as tmla
from repro_torch.nn.param import tree_flatten, tree_unflatten

ARCH = "deepseek-v2-236b"
RTOL = 1e-5
STEP_RTOL = 1e-4
BF16_TOL = 1e-2
B, S = 4, 16
TAPS = ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "kv_up", "wo")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _close_trees(port_tree, jax_tree, rtol=STEP_RTOL):
    """Leafwise, to ``rtol`` of the leaf's largest element."""
    got = interop.params_to_numpy(port_tree)
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


# --- mla_attention and its taps --------------------------------------------

def _mla_cfgs():
    jcfg = jreg.get(ARCH).smoke().mla
    cfg = registry.get(ARCH).smoke().mla
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.scale == jcfg.scale
    return jcfg, cfg


def _tap_groups(module, monkeypatch, params):
    """Give each tapped op of ``module`` its parameter's name as its group
    (the parameters' shapes are distinct at these widths)."""
    names = {}
    for k, v in params.items():
        names[tuple(np.shape(v["w"] if "w" in v else v["g"]))] = k
    assert len(names) == len(TAPS)
    linear, rmsnorm = module.linear, module.rmsnorm

    def lin(p, x, *, tap, group="all"):
        return linear(p, x, tap=tap, group=names[tuple(p["w"].shape)])

    def norm(p, x, *, tap, **kw):
        return rmsnorm(p, x, tap=tap, group=names[tuple(p["g"].shape)], **kw)

    monkeypatch.setattr(module, "linear", lin)
    monkeypatch.setattr(module, "rmsnorm", norm)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_attention_and_tap_stats_match_reference(dt, monkeypatch):
    """Output at 1e-5 (f32); each tap's per-example stat: L_j = Σ y_j ⊙ r_j
    for a fixed random cotangent r, one norm column per tap."""
    jdt, tdt = DTYPES[dt]
    jcfg, cfg = _mla_cfgs()
    jp = unbox(jmla.init_mla(jax.random.PRNGKey(1), jcfg, dtype=jdt))
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    tp = interop.params_from_numpy(np_p, device="cpu")
    rng = np.random.default_rng(5)
    x, r = (rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
            for _ in range(2))
    jb = {"x": jnp.asarray(x, jdt), "r": jnp.asarray(r, jdt)}
    tb = {"x": torch.from_numpy(x).to(tdt), "r": torch.from_numpy(r).to(tdt)}

    y_want, cache = jmla.mla_attention(jp, jb["x"], tap=jpex.NULL, cfg=jcfg)
    assert cache is None
    y = tmla.mla_attention(tp, tb["x"], tap=pex.NULL, cfg=cfg)
    assert y.dtype == tdt
    if dt == "f32":
        _close(y, y_want, RTOL)
    else:
        _close_max(y, y_want, BF16_TOL)

    def jloss(p, b, tap):
        out, _ = jmla.mla_attention(p, b["x"], tap=tap, cfg=jcfg)
        return jnp.sum((out * b["r"]).astype(jnp.float32), axis=(1, 2)), {}

    def tloss(p, b, tap):
        out = tmla.mla_attention(p, b["x"], tap=tap, cfg=cfg)
        return torch.sum((out * b["r"]).float(), dim=(1, 2)), {}

    _tap_groups(jmla, monkeypatch, np_p)
    _tap_groups(tmla, monkeypatch, np_p)
    eng = jpex.Engine(jpex.PexSpec(groups=TAPS))
    want = jax.jit(lambda p, b: eng.step(jloss, p, b, [jpex.Norms()]))(
        jp, jb).sq_norms
    got = pex.Engine(pex.PexSpec(groups=TAPS)).step(
        tloss, tp, tb, [pex.Norms()]).sq_norms
    assert got.shape == (B, len(TAPS))
    assert bool((got > 0).all())
    if dt == "f32":
        _close(got, want, RTOL)
    else:
        for i in range(len(TAPS)):   # each tap's column on its own scale
            _close_max(got[:, i], np.asarray(want)[:, i], BF16_TOL)


def test_mla_kv_norm_sees_only_the_latent():
    """kv_down's output splits into the 512-d latent (here 16) and the rope
    key; the kv_norm scale tap sees the latent alone."""
    _, cfg = _mla_cfgs()
    p = tmla.init_mla(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32, device="cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    seen = []

    class Spy:
        live = False

        def dense(self, h, w, *, group="all", method=None):
            return h @ w

        def scale(self, h, g, *, group="all"):
            seen.append(h.shape[-1])
            return h * g

    c, krope = tmla._latent_kv(p, x, Spy(), cfg, "attn")
    assert seen == [cfg.kv_lora]
    assert c.shape[-1] == cfg.kv_lora and krope.shape[-1] == cfg.qk_rope


def test_mla_cache_raises():
    """A latent cache without its cache_index raises; one from
    ``init_mla_cache`` is written in place at [cache_index, cache_index +
    S) (the absorbed form itself is held against the reference in
    ``tests/test_torch_serve_cache.py``)."""
    _, cfg = _mla_cfgs()
    p = tmla.init_mla(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32, device="cpu")
    x = torch.ones(1, 3, cfg.d_model)
    cache = tmla.init_mla_cache(1, 8, cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="cache_index"):
        tmla.mla_attention(p, x, tap=pex.NULL, cfg=cfg, cache=cache)
    tmla.mla_attention(p, x, tap=pex.NULL, cfg=cfg, cache=cache,
                       cache_index=2)
    for buf in cache.values():
        assert bool(buf[:, 2:5].all()) and not buf[:, :2].any() \
            and not buf[:, 5:].any()


# --- the deepseek-v2-236b smoke step ------------------------------------------

VARIANTS = {"smoke": {},
            "scale16_shared2": dict(routed_scale=16.0, n_shared=2),
            "scale16_shared2_drops": dict(routed_scale=16.0, n_shared=2,
                                          dispatch_groups=2,
                                          capacity_factor=0.5)}


def _edit(cfg, variant):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **VARIANTS[variant]))


def _setup(variant):
    jspec, spec = jreg.get(ARCH), registry.get(ARCH)
    jcfg, cfg = _edit(jspec.smoke(), variant), _edit(spec.smoke(), variant)
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(
        variant=variant, cfg=cfg, jparams=jparams, np_params=np_params,
        jloss=jreg.make_loss_fn_v2(jspec, jcfg),
        jbatch=jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B),
                                     3),
        params=interop.params_from_numpy(np_params, device="cpu"),
        batch=registry.make_train_batch(spec, cfg, ShapeSpec("t", "train",
                                                             S, B), 3,
                                        device="cpu"),
        loss=registry.make_loss_fn_v2(spec, cfg))


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    return _setup(request.param)


def test_registry_resolves_deepseek():
    """The port's deepseek-v2-236b has the reference's published config."""
    full, jfull = registry.get(ARCH).full(), jreg.get(ARCH).full()
    for k in ("name", "n_layers", "d_model", "vocab", "n_dense_prefix",
              "rms_eps", "dtype"):
        assert getattr(full, k) == getattr(jfull, k), k
    assert full.attn is None and jfull.attn is None
    for sub in ("mla", "moe", "dense_prefix_mlp"):
        assert dataclasses.asdict(getattr(full, sub)) \
            == dataclasses.asdict(getattr(jfull, sub)), sub
    assert full.moe.routed_scale == 16.0 and full.moe.n_shared == 2


def test_prefix_round_trips_through_interop(setup):
    """The reference's ``prefix`` list of dense layers carries over to the
    port's ``params["prefix"]`` and back unchanged, beside the blocks; the
    port's own ``init`` gives the reference's tree of shapes."""
    cfg, params = setup["cfg"], setup["params"]
    assert isinstance(params["prefix"], list)
    assert len(params["prefix"]) == cfg.n_dense_prefix
    assert len(params["blocks"]) == cfg.n_layers - cfg.n_dense_prefix
    assert "mlp" in params["prefix"][0] and "moe" not in params["prefix"][0]
    assert all("moe" in blk for blk in params["blocks"])
    shared = cfg.moe.n_shared * cfg.moe.d_ff
    assert params["blocks"][0]["moe"]["shared"]["up"]["w"].shape \
        == (cfg.d_model, shared)
    back = interop.params_to_numpy(params)
    flat = jax.tree_util.tree_leaves_with_path(setup["np_params"])
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(got, want)
    own = registry.family_module(registry.get(ARCH)).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(np.shape, interop.params_to_numpy(own)) \
        == jax.tree_util.tree_map(np.shape, setup["np_params"])


def _steps(st, consumers, jconsumers):
    t = pex.Engine(pex.PexSpec()).step(st["loss"], st["params"], st["batch"],
                                       consumers)
    eng = jpex.Engine(jpex.PexSpec())
    j = jax.jit(lambda p, b: eng.step(st["jloss"], p, b, jconsumers))(
        st["jparams"], st["jbatch"])
    return t, j


def test_step_norms_clip_and_grads_match(setup, monkeypatch):
    """[Norms, Clip(1.0)]: loss_vec, norms, clip coefficients and the
    clipped gradients at 1e-4. In the dropping variant over a fifth of the
    token-expert assignments find no slot (counted at the expert taps)."""
    kept = []
    grouped = tT.Tap.dense_expert_grouped

    def counted(self, x, w, seg, bg, tok=None, **kw):
        kept.append(int((seg < bg).sum()))
        return grouped(self, x, w, seg, bg, tok, **kw)

    monkeypatch.setattr(tT.Tap, "dense_expert_grouped", counted)
    t, j = _steps(setup, [pex.Norms(), pex.Clip(1.0)],
                  [jpex.Norms(), jpex.Clip(1.0)])
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    _close(t.clip_coef, j.clip_coef)
    assert 0 < float(t.clip_coef.min()) < 1.0
    _close_trees(t.grads, j.grads)
    moe = setup["cfg"].moe
    n_moe = setup["cfg"].n_layers - setup["cfg"].n_dense_prefix
    assert len(kept) == 3 * n_moe
    assert max(kept) <= B * S * moe.top_k
    if setup["variant"].endswith("drops"):
        assert max(kept) < 0.8 * B * S * moe.top_k


def test_step_norms_and_grads_match_the_batched_oracle(setup):
    """The port's [Norms, Grads] against its own plain autograd: the norms
    against example j's gradient of one batched forward (a loop of
    ``autograd.grad`` calls over one graph), < 1e-4; the summed gradients
    against the batch backward at 1e-4."""
    t = pex.Engine(pex.PexSpec()).step(setup["loss"], setup["params"],
                                       setup["batch"],
                                       [pex.Norms(), pex.Grads()])
    leaves, treedef = tree_flatten(setup["params"])
    leaves = [x.detach().requires_grad_() for x in leaves]
    lv = setup["loss"](tree_unflatten(treedef, leaves), setup["batch"],
                       pex.NULL)[0]
    want = torch.stack([
        sum(torch.sum(g * g) for g in torch.autograd.grad(
            lv[i], leaves, retain_graph=True)) for i in range(B)])
    got = t.sq_norms.sum(-1)
    assert float(torch.max(torch.abs(got - want) / want)) < 1e-4
    for g_eng, g in zip(tree_flatten(t.grads)[0],
                        torch.autograd.grad(lv.sum(), leaves)):
        torch.testing.assert_close(g_eng, g, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * float(g.abs().max()))


def test_routed_scale_and_shared_experts_bind():
    """On the same parameters, routed_scale 16 against 1 and the shared
    experts' down projection zeroed change the loss: a port that dropped
    either would not match the reference in the variants above."""
    spec = registry.get(ARCH)
    cfg = _edit(spec.smoke(), "scale16_shared2")
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", S,
                                                           B), 3,
                                      device="cpu")

    def loss(c, p):
        return registry.make_loss_fn_v2(spec, c)(p, batch, pex.NULL)[0]

    base = loss(cfg, params)
    unscaled = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, routed_scale=1.0))
    assert float((loss(unscaled, params) - base).abs().max()) > 1e-3
    params["blocks"][0]["moe"]["shared"]["down"]["w"].zero_()
    assert float((loss(cfg, params) - base).abs().max()) > 1e-3
