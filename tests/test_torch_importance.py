"""The port's importance sampling and its Importance plan against the
reference's.

The sampling math (``core.importance``) is compared on the same numpy
pools, degenerate ones included. The draws cannot match across RNGs: the
port draws through one site, ``importance._choice``, which these tests
patch to return the reference's own indices under its key, so the plan's
split (norms on the pool, sample, gather, one weighted gradient pass on the
sub-batch) is held to the reference's on ``tests/test_plan.py``'s toy
problem and on the llama3.2-1b smoke step at 1e-4 relative, 1e-6 absolute.
The port's own draws are checked by their frequencies.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import importance as jimp
from repro.core import plan as jplan
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import importance as timp
from repro_torch.core import plan as tplan
from repro_torch.models import registry

from test_plan import _loss_v2 as _jtoy_loss
from test_plan import _toy

RTOL, ATOL = 1e-4, 1e-6


def _toy_loss(p, b, tap):
    """``tests/test_plan.py``'s toy loss, written against the port's tap."""
    h = tap.embedding(p["emb"], b["ids"])
    z = tap.dense(h, p["w1"])
    z = tap.bias_add(z, p["b1"])
    h = torch.nn.functional.gelu(torch.cumsum(z, dim=1), approximate="tanh")
    h = tap.scale(h, p["g"])
    logp = torch.log_softmax(tap.dense(h, p["w2"]), dim=-1)
    ll = torch.gather(logp, -1, b["labels"][..., None])[..., 0]
    return torch.sum(tap.token_loss(-ll), dim=-1), {}


def _to_torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


POOLS = {"healthy": [1.0, 4.0, 0.25, 9.0, 2.0],
         "with zeros": [0.0, 4.0, 0.0, 1.0, 0.0],
         "all zero": [0.0, 0.0, 0.0, 0.0],
         "nan": [1.0, np.nan, 2.0, 1.0],
         "inf": [1.0, np.inf, 2.0],
         "negative": [-1e-9, 1.0, 3.0]}


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_sampling_distribution_matches_reference(pool, smoothing):
    sq = np.asarray(POOLS[pool], np.float32)
    degenerate = pool in ("all zero", "nan", "inf")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        want = jimp.sampling_distribution(jnp.asarray(sq), smoothing)
        got = timp.sampling_distribution(torch.from_numpy(sq), smoothing)
    msgs = [str(w.message) for w in seen
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == (2 if degenerate else 0)
    assert len(set(msgs)) <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0.0)
    # (B, G) pools sum their groups first
    sq2 = np.stack([sq, np.zeros_like(sq)], -1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(
            timp.sampling_distribution(torch.from_numpy(sq2),
                                       smoothing).numpy(),
            np.asarray(jimp.sampling_distribution(jnp.asarray(sq2),
                                                  smoothing)),
            rtol=1e-6, atol=0.0)


def test_sample_weights_for_given_indices(monkeypatch):
    """With the reference's indices injected at the draw site, the weights
    1/(k·p_j) and the distribution equal the reference's."""
    sq = np.asarray([[1.0, 0.5], [4.0, 0.0], [0.25, 0.25], [9.0, 1.0]],
                    np.float32)
    key = jax.random.PRNGKey(11)
    want = jimp.sample(key, jnp.asarray(sq), 3, smoothing=0.1)
    monkeypatch.setattr(timp, "_choice",
                        lambda gen, p, k, replace: torch.tensor(
                            np.asarray(want.indices)))
    got = timp.sample(torch.Generator(), torch.from_numpy(sq), 3,
                      smoothing=0.1)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-6)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(timp.effective_sample_size(got.weights)),
        float(jimp.effective_sample_size(want.weights)), rtol=1e-6)


def test_gather_batch_skips_scalar_and_static_leaves():
    idx = [2, 0]
    jb = {"ids": jnp.arange(12).reshape(4, 3), "step": jnp.asarray(7),
          "flag": True, "temp": 0.5}
    tb = {"ids": torch.arange(12).reshape(4, 3), "step": torch.tensor(7),
          "flag": True, "temp": 0.5}
    want = jimp.gather_batch(jb, jnp.asarray(idx))
    got = timp.gather_batch(tb, torch.tensor(idx))
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    assert int(got["step"]) == 7 and got["step"].ndim == 0
    assert got["flag"] is True and got["temp"] == 0.5
    # a non-batch vector leaf is ambiguous without an explicit batch_size
    amb = {"ids": torch.zeros((4, 3)), "scale": torch.ones((5,))}
    with pytest.raises(ValueError, match="batch_size"):
        timp.gather_batch(amb, torch.tensor([0]))
    out = timp.gather_batch(amb, torch.tensor([1, 3]), batch_size=4)
    assert out["ids"].shape == (2, 3) and out["scale"].shape == (5,)
    # numpy leaves are gathered too
    out = timp.gather_batch({"x": np.arange(8).reshape(4, 2)},
                            torch.tensor([3, 1]))
    np.testing.assert_array_equal(out["x"], [[6, 7], [2, 3]])


@pytest.mark.parametrize("replace", [True, False])
def test_own_draws_follow_p(replace):
    """The port's draws from a seeded generator: frequencies ∝ p with
    replacement; distinct indices without."""
    p = torch.tensor([0.1, 0.4, 0.05, 0.3, 0.15])
    gen = torch.Generator().manual_seed(0)
    if replace:
        idx = timp._choice(gen, p, 40_000, True)
        freq = torch.bincount(idx, minlength=5).double() / idx.numel()
        np.testing.assert_allclose(freq.numpy(), p.double().numpy(),
                                   atol=0.01)
    else:
        idx = timp._choice(gen, p, 5, False)
        assert sorted(idx.tolist()) == [0, 1, 2, 3, 4]
    again = timp._choice(torch.Generator().manual_seed(0), p, idx.numel(),
                         replace)
    torch.testing.assert_close(again, idx, rtol=0, atol=0)


def _inject(monkeypatch, jres):
    monkeypatch.setattr(timp, "_choice",
                        lambda gen, p, k, replace: torch.tensor(
                            np.asarray(jres.sample.indices)))


def _check(got, want, consumers_have_clip):
    np.testing.assert_array_equal(got.sample.indices.numpy(),
                                  np.asarray(want.sample.indices))
    _close(got.loss_vec, want.loss_vec)
    _close(got.sq_norms, want.sq_norms)
    _close(got.sub_sq_norms, want.sub_sq_norms)
    _close(got.sample.weights, want.sample.weights)
    _close(got.weights, want.weights)
    if consumers_have_clip:
        _close(got.clip_coef, want.clip_coef)
    return got.grads, want.grads


@pytest.mark.parametrize("k, clip", [(2, None), (3, 0.5)])
def test_importance_plan_on_toy_problem(monkeypatch, k, clip):
    params, batch = _toy()
    key = jax.random.PRNGKey(3 + k)
    tail_j = [jpex.Grads()] if clip is None else [jpex.Clip(clip)]
    tail_t = [pex.Grads()] if clip is None else [pex.Clip(clip)]
    want = jpex.Engine(jpex.PexSpec(method="gram")).step(
        _jtoy_loss, params, batch,
        [jpex.Importance(k, smoothing=0.2, rng=key)] + tail_j)
    _inject(monkeypatch, want)
    got = pex.Engine(pex.PexSpec(method="gram")).step(
        _toy_loss, _to_torch(params), _to_torch(batch),
        [pex.Importance(k, smoothing=0.2, rng=torch.Generator())] + tail_t)
    tg, jg = _check(got, want, clip is not None)
    for name in params:
        _close(tg[name], jg[name])


@pytest.mark.parametrize("k, clip", [(2, None), (3, 1.0)])
def test_importance_plan_on_llama_smoke(monkeypatch, k, clip):
    b, s = 6, 12
    jspec = jreg.get("llama3.2-1b")
    jcfg = jspec.smoke()
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", s, b), 5)
    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", s, b),
                                      5, device="cpu")
    tail_j = [jpex.Grads()] if clip is None else [jpex.Clip(clip),
                                                   jpex.GNS()]
    tail_t = [pex.Grads()] if clip is None else [pex.Clip(clip), pex.GNS()]
    want = jpex.Engine(jpex.PexSpec()).step(
        jreg.make_loss_fn_v2(jspec, jcfg), jparams, jbatch,
        [jpex.Importance(k, rng=jax.random.PRNGKey(7))] + tail_j)
    _inject(monkeypatch, want)
    got = pex.Engine(pex.PexSpec()).step(
        registry.make_loss_fn_v2(spec, cfg), params, batch,
        [pex.Importance(k, rng=torch.Generator())] + tail_t)
    tg, jg = _check(got, want, clip is not None)
    if clip is not None:
        _close(got.gns, want.gns)
    got_np = interop.params_to_numpy(tg)
    for path, w in jax.tree_util.tree_leaves_with_path(jg):
        g = got_np
        for p in path:
            g = g[p.key]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=max(ATOL, RTOL * np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


CONSUMER_LISTS = {
    "plain": lambda m, r: [],
    "grads": lambda m, r: [m.Grads()],
    "norms+grads": lambda m, r: [m.Norms(), m.Grads()],
    "clip+noise+gns": lambda m, r: [m.Norms(), m.Clip(1.0),
                                    m.Noise(0.1, r), m.GNS()],
    "importance": lambda m, r: [m.Importance(4, rng=r), m.Grads()],
    "importance+clip": lambda m, r: [m.Importance(2, rng=r), m.Clip(0.5),
                                     m.GNS()],
    "importance only": lambda m, r: [m.Importance(2, rng=r)],
    "token clip": lambda m, r: [m.Clip(0.5, granularity="token"),
                                m.Grads()],
}


@pytest.mark.parametrize("name", sorted(CONSUMER_LISTS))
def test_describe_and_static_cost_match_reference(name):
    make = CONSUMER_LISTS[name]
    jp = jplan.analyze(make(jplan, jax.random.PRNGKey(0)))
    tp = tplan.analyze(make(tplan, torch.Generator()))
    assert tp.n_backwards == jp.n_backwards
    for kw in ({}, {"fwd_flops": 3.5e9}, {"param_bytes": 2.2e6},
               {"fwd_flops": 1e12, "param_bytes": 4e9}):
        assert tp.describe(**kw) == jp.describe(**kw)
        assert tp.static_cost(**kw) == jp.static_cost(**kw)


def test_importance_needs_a_generator():
    params, batch = _toy()
    with pytest.raises(ValueError, match="rng"):
        pex.Engine(pex.PexSpec()).step(
            _toy_loss, _to_torch(params), _to_torch(batch),
            [pex.Importance(2), pex.Grads()])
