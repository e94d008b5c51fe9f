"""Shared by ``tests/test_torch_rwkv.py``, ``tests/test_torch_zamba2.py``
and ``tests/test_torch_seamless.py``: the reference's smoke setup carried
into the port, the step comparisons against the reference's jitted
``Engine.step``, and one ``PexSpec`` group per tap call for the unit stats.

Tolerances: f32 steps 1e-4 (layers of reductions in another order), units
and each tap's stat 1e-5, bf16 within 1e-2 of the largest |value| — the
outputs round to bf16 (2^-8 relative) and the two packages' f32
transcendentals may put a value on either side of a rounding step. A bf16
tap stat behind a long chain of bf16 cotangents (the recurrences' inputs)
can sit further than that from its f32 value in the reference itself:
there the port is held within twice the reference's own distance from the
f32 stat (``close_stats_bf16``), the most two bf16 evaluations of one f32
value can differ by when each errs as far as the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import taps as jT
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import naive
from repro_torch.core import taps as tT
from repro_torch.models import registry
from repro_torch.nn.param import tree_flatten, tree_unflatten

STEP_RTOL = 1e-4
RTOL = 1e-5
BF16_TOL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def close(got, want, rtol=STEP_RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def close_max(got, want, tol):
    """Elementwise within ``tol`` of the largest |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def close_dt(got, want, dt):
    """f32 at ``RTOL``, bf16 within ``BF16_TOL`` of the largest |value|."""
    if dt == "f32":
        close(got, want, RTOL)
    else:
        close_max(got, want, BF16_TOL)


def close_stats_bf16(got, want, truth):
    """bf16 per-tap stat columns: column i of ``got`` (the port's) within
    max(BF16_TOL, 2·e_i) of the column's largest |value| of ``want`` (the
    reference's), e_i being the reference's own distance from ``truth``
    (the f32 stats on the same bf16-rounded parameters and inputs) on that
    scale. Returns the e_i."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    truth = np.asarray(truth, np.float32)
    assert got.shape == want.shape == truth.shape
    errs = []
    for i in range(want.shape[1]):
        scale = float(np.abs(want[:, i]).max())
        e = float(np.abs(want[:, i] - truth[:, i]).max()) / scale
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=0,
                                   atol=max(BF16_TOL, 2 * e) * scale,
                                   err_msg=f"column {i}")
        errs.append(e)
    return errs


def close_trees(port_tree, jax_tree, rtol=STEP_RTOL):
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


def pair(rng, shape, dt, scale=1.0):
    """The same numpy draw as a JAX and a torch array of dtype ``dt``."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def setup(arch, b, s, edit=lambda cfg: cfg):
    """The reference's smoke ``init`` (key 0) carried into the port by
    ``interop``; both packages' batches from numpy seed 3."""
    jspec, spec = jreg.get(arch), registry.get(arch)
    jcfg, cfg = edit(jspec.smoke()), edit(spec.smoke())
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(
        arch=arch, cfg=cfg, jparams=jparams, np_params=np_params,
        jloss=jreg.make_loss_fn_v2(jspec, jcfg),
        jbatch=jreg.make_train_batch(jspec, jcfg, JShape("t", "train", s, b),
                                     3),
        params=interop.params_from_numpy(np_params, device="cpu"),
        batch=registry.make_train_batch(spec, cfg, ShapeSpec("t", "train",
                                                             s, b), 3,
                                        device="cpu"),
        loss=registry.make_loss_fn_v2(spec, cfg))


def steps(st, consumers, jconsumers, method="auto", groups=("all",)):
    """Both packages' ``Engine.step``, the reference's jitted."""
    t = pex.Engine(pex.PexSpec(method=method, groups=groups)).step(
        st["loss"], st["params"], st["batch"], consumers)
    eng = jpex.Engine(jpex.PexSpec(method=method, groups=groups))
    j = jax.jit(lambda p, b: eng.step(st["jloss"], p, b, jconsumers))(
        st["jparams"], st["jbatch"])
    return t, j


def round_trip(st):
    """interop both ways gives the reference's arrays back exactly, the
    port's own ``init`` gives the reference's tree of shapes, and both
    packages' batches hold the same arrays."""
    back = interop.params_to_numpy(st["params"])
    flat = jax.tree_util.tree_leaves_with_path(st["np_params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat)
    for path, want in flat:
        np.testing.assert_array_equal(flat_back[path], want)
    spec = registry.get(st["arch"])
    own = registry.family_module(spec).init(
        st["cfg"], torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(np.shape, interop.params_to_numpy(own)) \
        == jax.tree_util.tree_map(np.shape, st["np_params"])
    for k, v in st["jbatch"].items():
        np.testing.assert_array_equal(st["batch"][k].float().numpy(),
                                      np.asarray(v, np.float32))
    assert sorted(st["batch"]) == sorted(st["jbatch"])


def scope_matches_reference(st):
    """The port's ``scope_mask`` (its own allowlist on its key paths),
    carried to the reference's layout by ``interop``, selects the leaves
    the reference's ``scope_filter`` (``tests/helpers.py``) selects; and
    the declared leaves give no stat."""
    from helpers import scope_filter
    mask = registry.scope_mask(st["arch"], st["params"])
    leaves, treedef = tree_flatten(st["params"])
    marked = tree_unflatten(treedef, [torch.full(x.shape, float(m))
                                      for x, m in zip(leaves, mask)])
    got = dict(jax.tree_util.tree_leaves_with_path(
        interop.params_to_numpy(marked)))
    keep = scope_filter(st["arch"])
    n_out = 0
    for path, _ in jax.tree_util.tree_leaves_with_path(st["np_params"]):
        want = keep(path)
        n_out += not want
        assert bool((got[path] == float(want)).all()), \
            jax.tree_util.keystr(path)
    return n_out


def norms_match_own_oracle(st):
    """The port's fused norms against its own naive oracle (``torch.func``
    vmap over grad) over the scoped leaves, max rel err < 1e-4."""
    t = pex.Engine(pex.PexSpec()).step(st["loss"], st["params"], st["batch"],
                                       [pex.Norms()])
    loss = st["loss"]

    def single(p, ex):
        b1 = {k: v[None] for k, v in ex.items()}
        return loss(p, b1, pex.NULL)[0][0]

    grads = naive.per_example_grads(single, st["params"], st["batch"])
    mask = registry.scope_mask(st["arch"], st["params"])
    scoped = [g for g, m in zip(tree_flatten(grads)[0], mask) if m]
    oracle = naive.per_example_grad_tree_norms(scoped)
    got = t.sq_norms.sum(-1)
    assert float(torch.max(torch.abs(got - oracle) / oracle)) < 1e-4
    return grads, mask


def per_call_groups(monkeypatch, names):
    """Give the k-th dense, bias or scale tap call of each package (mod the
    number of ``names``) the group ``names[k]``: both packages call their
    taps in one order, so each tap gets its own norm column."""
    for cls in (jT.Tap, tT.Tap):
        count = [0]
        for op in ("dense", "bias_add", "scale"):
            fn = getattr(cls, op)

            def wrapped(self, *a, _fn=fn, _count=count, **kw):
                kw["group"] = names[_count[0] % len(names)]
                _count[0] += 1
                return _fn(self, *a, **kw)

            monkeypatch.setattr(cls, op, wrapped)


def check_bf16_dtypes(arch, f32_keys):
    """Both packages' bf16 ``init``: the leaves named in ``f32_keys`` f32,
    every other leaf bf16; one AdamW update and the in-place noise add on
    the port's tree keep every leaf's dtype."""
    import dataclasses

    from repro_torch.core import passes
    from repro_torch.nn.param import tree_paths
    from repro_torch.optim import adamw

    jspec, spec = jreg.get(arch), registry.get(arch)
    jparams = unbox(jreg.family_module(jspec).init(
        jax.random.PRNGKey(0),
        dataclasses.replace(jspec.smoke(), dtype="bfloat16")))
    for path, x in jax.tree_util.tree_leaves_with_path(jparams):
        f32 = path[-1].key in f32_keys
        assert x.dtype == (jnp.float32 if f32 else jnp.bfloat16), path
    params = registry.family_module(spec).init(
        dataclasses.replace(spec.smoke(), dtype="bfloat16"),
        torch.Generator().manual_seed(0), device="cpu")

    def dtypes(tree):
        return [(p[-1] in f32_keys, x.dtype)
                for p, x in zip(tree_paths(tree), tree_flatten(tree)[0])]

    want = [(f32, torch.float32 if f32 else torch.bfloat16)
            for f32, _ in dtypes(params)]
    assert dtypes(params) == want
    assert any(f32 for f32, _ in want)
    leaves, treedef = tree_flatten(params)
    grads = tree_unflatten(treedef, [torch.full_like(x, 0.01)
                                     for x in leaves])
    adamw.update(adamw.AdamWConfig(), adamw.init(params), params, grads)
    passes.add_grad_noise(grads, 0.1, 1.0, torch.Generator().manual_seed(0))
    assert dtypes(params) == want and dtypes(grads) == want
