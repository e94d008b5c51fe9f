"""The port's llama3.2-1b step against the JAX reference's.

On the llama3.2-1b smoke config, the reference's ``init`` parameters are
carried into the port by ``repro_torch.interop``, the batch is drawn from
the same numpy seed, and ``Engine.step`` of both packages is compared:
loss_vec, grads, per-example (per-group) norms, clip coefficients, GNS
and — with one noise sample injected into both — the DP-SGD noised grads.
The port's norms are also held against its own naive oracle
(``torch.func`` vmap over grad). Tolerance: f32, 1e-4 relative for the
slice (layers of reductions in another order), 1e-4 for the naive oracle
as in ``examples/quickstart.py``.

Also here: the import rule of the port (no JAX, nothing of ``repro``) and
its device rule (CUDA unless the caller names the CPU).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro.optim import adamw as jadamw
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import naive, passes
from repro_torch.core import norms as tN
from repro_torch.core import taps as tT
from repro_torch.kernels import ops as tops
from repro_torch.models import registry
from repro_torch.nn.param import tree_flatten
from repro_torch.optim import adamw

RTOL = 1e-4
ATOL = 1e-6
B, S = 3, 12
ARCH = "llama3.2-1b"
GROUPS = ("attn", "mlp", "norm", "embed", "head")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jspec = jreg.get(ARCH)
    jcfg = jspec.smoke()
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    spec = registry.get(ARCH)
    cfg = spec.smoke()
    params = interop.params_from_numpy(np_params, device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", S, B),
                                      3, device="cpu")
    return dict(jloss=jreg.make_loss_fn_v2(jspec, jcfg), jparams=jparams,
                jbatch=jbatch, np_params=np_params, cfg=cfg, params=params,
                batch=batch, loss=registry.make_loss_fn_v2(spec, cfg))


def _jax_step(st, consumers, groups=("all",)):
    eng = jpex.Engine(jpex.PexSpec(groups=groups))
    return eng.step(st["jloss"], st["jparams"], st["jbatch"], consumers)


def _port_step(st, consumers, groups=("all",)):
    eng = pex.Engine(pex.PexSpec(groups=groups))
    return eng.step(st["loss"], st["params"], st["batch"], consumers)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_trees(port_tree, jax_tree, rtol=RTOL):
    """Leafwise, to ``rtol`` of the leaf's largest element: gradient
    entries that are sums of cancelling terms (embedding rows hit by
    several tokens) have no meaningful elementwise relative error."""
    got = interop.params_to_numpy(port_tree)
    want = jax.tree_util.tree_map(np.asarray, jax_tree)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = flat_want[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_batch_and_params_carry_over(setup):
    np.testing.assert_array_equal(setup["batch"]["ids"].numpy(),
                                  np.asarray(setup["jbatch"]["ids"]))
    np.testing.assert_array_equal(setup["batch"]["labels"].numpy(),
                                  np.asarray(setup["jbatch"]["labels"]))
    back = interop.params_to_numpy(setup["params"])
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(setup["np_params"])):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert len(setup["params"]["blocks"]) == setup["cfg"].n_layers


def test_loss_vec_matches(setup):
    want, _ = setup["jloss"](setup["jparams"], setup["jbatch"], jpex.NULL)
    got, _ = setup["loss"](setup["params"], setup["batch"], pex.NULL)
    _close(got, want)


@pytest.mark.parametrize("groups", [("all",), GROUPS])
def test_norms_and_grads_match(setup, groups):
    j = _jax_step(setup, [jpex.Norms(), jpex.Grads()], groups)
    t = _port_step(setup, [pex.Norms(), pex.Grads()], groups)
    assert t.sq_norms.shape == (B, len(groups))
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)


def test_norms_only_matches(setup):
    j = _jax_step(setup, [jpex.Norms()])
    t = _port_step(setup, [pex.Norms()])
    assert t.grads is None
    _close(t.sq_norms, j.sq_norms)


def test_clip_matches(setup):
    j = _jax_step(setup, [jpex.Norms(), jpex.Clip(1.0)])
    t = _port_step(setup, [pex.Norms(), pex.Clip(1.0)])
    _close(t.sq_norms, j.sq_norms)
    _close(t.clip_coef, j.clip_coef)
    _close(t.weights, j.weights)
    _close_trees(t.grads, j.grads)


def test_clip_noise_gns_with_injected_sample(setup, monkeypatch):
    """Both packages add the same N(0, 1) sample: the reference's own draw
    (recovered as noised − clean grads) is handed to the port."""
    sigma, c = 0.1, 1.0
    clean = _jax_step(setup, [jpex.Norms(), jpex.Clip(c), jpex.GNS()])
    noisy = _jax_step(setup, [jpex.Norms(), jpex.Clip(c),
                              jpex.Noise(sigma, jax.random.PRNGKey(5)),
                              jpex.GNS()])
    sample = jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / (sigma * c),
        noisy.grads, clean.grads)
    draws = tree_flatten(interop.params_from_numpy(sample, device="cpu"))[0]

    def injected(shape, generator, device):
        d = draws.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return d

    monkeypatch.setattr(passes, "_standard_normal", injected)
    t = _port_step(setup, [pex.Norms(), pex.Clip(c),
                           pex.Noise(sigma, torch.Generator()), pex.GNS()])
    assert draws == []
    _close(t.clip_coef, noisy.clip_coef)
    _close(t.gns, noisy.gns)
    _close_trees(t.grads, noisy.grads)


def test_gns_and_sugar_match(setup):
    jeng = jpex.Engine(jpex.PexSpec(), clip_norm=0.5)
    teng = pex.Engine(pex.PexSpec(), clip_norm=0.5)
    _close(teng.gradient_noise_scale(setup["loss"], setup["params"],
                                     setup["batch"]),
           jeng.gradient_noise_scale(setup["jloss"], setup["jparams"],
                                     setup["jbatch"]))
    j = jeng.clipped_step(setup["jloss"], setup["jparams"], setup["jbatch"])
    t = teng.clipped_step(setup["loss"], setup["params"], setup["batch"])
    _close_trees(t.grads, j.grads)
    r = teng.value_and_norms(setup["loss"], setup["params"], setup["batch"])
    _close(r.sq_norms, j.sq_norms)
    r = teng.value_grads_and_norms(setup["loss"], setup["params"],
                                   setup["batch"])
    _close(r.loss, j.loss)


def test_plain_forward_and_loss_weights(setup):
    w = np.array([0.5, 2.0, 1.0], np.float32)
    j = _jax_step(setup, [])
    t = _port_step(setup, [])
    assert t.grads is None and t.sq_norms is None
    _close(t.loss, j.loss)
    jeng = jpex.Engine(jpex.PexSpec())
    teng = pex.Engine(pex.PexSpec())
    for jc, tc in (([jpex.Grads()], [pex.Grads()]),
                   ([jpex.Norms(), jpex.Grads()], [pex.Norms(), pex.Grads()])):
        jr = jeng.step(setup["jloss"], setup["jparams"], setup["jbatch"], jc,
                       loss_weights=jnp.asarray(w))
        tr = teng.step(setup["loss"], setup["params"], setup["batch"], tc,
                       loss_weights=torch.from_numpy(w))
        _close_trees(tr.grads, jr.grads)


def test_norms_match_naive_oracle(setup):
    """The port's fused norms against its own per-example backprop
    (``torch.func`` vmap over grad), max rel err < 1e-4."""
    t = _port_step(setup, [pex.Norms()])
    loss = setup["loss"]

    def single(p, ex):
        b1 = {k: v[None] for k, v in ex.items()}
        return loss(p, b1, pex.NULL)[0][0]

    oracle = naive.per_example_sq_norms(single, setup["params"],
                                        setup["batch"])
    got = t.sq_norms.sum(-1)
    assert float(torch.max(torch.abs(got - oracle) / oracle)) < 1e-4


def test_kernel_route_matches_plain_route(setup, monkeypatch):
    """``use_kernels`` sends every gram/direct stat through the
    ``kernels.ops`` wrappers (one call per dense tap: 7 per layer and the
    head) and, off, through none; both match the reference's norms."""
    calls = {"gram_norm": 0, "direct_norm": 0}

    def counted(name):
        fn = getattr(tops, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tops, name, counted(name))
    want = _jax_step(setup, [jpex.Norms()]).sq_norms
    for use_kernels, n_calls in ((True, setup["cfg"].n_layers * 7 + 1),
                                 (False, 0)):
        calls.update(gram_norm=0, direct_norm=0)
        got = pex.Engine(pex.PexSpec(use_kernels=use_kernels)).step(
            setup["loss"], setup["params"], setup["batch"], [pex.Norms()])
        assert sum(calls.values()) == n_calls, (use_kernels, calls)
        _close(got.sq_norms, want)


def test_each_backward_does_only_its_work(setup, monkeypatch):
    """In the Clip plan the norms backward forms no dW and the reweighted
    backward computes no stat: each counted op runs exactly one pass's
    worth (2 layers × 7 dense taps + the head = 15)."""
    calls = {"stat": 0, "dw": 0}
    stat_dense, weight_grad = tN.stat_dense, tT._weight_grad

    def counted_stat(*a, **kw):
        calls["stat"] += 1
        return stat_dense(*a, **kw)

    def counted_dw(*a, **kw):
        calls["dw"] += 1
        return weight_grad(*a, **kw)

    monkeypatch.setattr(tN, "stat_dense", counted_stat)
    monkeypatch.setattr(tT, "_weight_grad", counted_dw)
    _port_step(setup, [pex.Norms(), pex.Clip(1.0)])
    n_dense = setup["cfg"].n_layers * 7 + 1
    assert calls == {"stat": n_dense, "dw": n_dense}


def test_noise_without_a_generator_raises(setup):
    eng = pex.Engine(pex.PexSpec())
    with pytest.raises(ValueError, match="generator"):
        eng.step(setup["loss"], setup["params"], setup["batch"],
                 [pex.Clip(1.0), pex.Noise(0.5)])


def test_noise_moments():
    """The port's own draws: mean 0, standard deviation σ·C per leaf; the
    same seed draws the same noise. The add is in place, so each call gets
    a tree of its own."""
    def zeros():
        return {"a": torch.zeros(400, 500), "b": [torch.zeros(100_000)]}
    out = passes.add_grad_noise(zeros(), 0.3, 2.0,
                                torch.Generator().manual_seed(0))
    for x in tree_flatten(out)[0]:
        assert abs(float(x.mean())) < 0.01
        assert abs(float(x.std()) - 0.6) < 0.01
    again = passes.add_grad_noise(zeros(), 0.3, 2.0,
                                  torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, out, rtol=0, atol=0)


def test_adamw_update_matches(setup):
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32),
        setup["np_params"])
    cfg = dict(lr=1e-2, weight_decay=0.1, global_clip=1.0)
    jp, js = setup["jparams"], jadamw.init(setup["jparams"])
    tp = interop.params_from_numpy(setup["np_params"], device="cpu")
    ts = adamw.init(tp)
    for _ in range(2):
        jp, js = jadamw.update(jadamw.AdamWConfig(**cfg), js, jp,
                               jax.tree_util.tree_map(jnp.asarray, grads))
        tp, ts = adamw.update(adamw.AdamWConfig(**cfg), ts, tp,
                              interop.params_from_numpy(grads, device="cpu"))
    assert ts.step == 2
    _close_trees(tp, jp, rtol=1e-5)


def test_default_device_is_cuda(setup, monkeypatch):
    """An entry point called without device= runs on CUDA; with no card it
    raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = registry.get(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.family_module(spec).init(setup["cfg"], torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.make_train_batch(spec, setup["cfg"],
                                  ShapeSpec("t", "train", S, B))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_numpy(setup["np_params"])


def test_init_distributions():
    spec = registry.get(ARCH)
    cfg = spec.smoke()
    p = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.002
    assert abs(float(p["head"]["w"].std()) - 0.02) < 0.002
    w = p["blocks"][0]["mlp"]["down"]["w"]     # fan-in 128
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    assert bool((p["ln_f"]["g"] == 1).all())
    jshapes = jax.tree_util.tree_map(
        lambda x: x.shape, unbox(jreg.family_module(jreg.get(ARCH)).init(
            jax.random.PRNGKey(0), jreg.get(ARCH).smoke())))
    back = interop.params_to_numpy(p)
    assert jax.tree_util.tree_map(lambda x: x.shape, back) == jshapes


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 20 and len(examples) >= 3
    files += examples
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)
