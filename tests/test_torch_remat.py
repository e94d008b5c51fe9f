"""Activation rematerialization in the port (``core.taps.checkpoint``):
each family's blocks checkpointed in training, with the reference's
defaults (``remat=True``, ``remat_policy="full"``).

  * llama3.2-1b smoke in f32: ``full``, ``dots`` and ``remat=False`` give
    bit-identical loss, norms and gradients at example and at token
    granularity under ``[Clip, Noise]`` with one injected sample; each
    setting against the reference's jitted step with its default remat on
    the same numpy inputs, at ``tests/test_torch_llama_step.py``'s 1e-4.
  * One step of rwkv6-3b, zamba2-7b, seamless-m4t-medium and phi3.5-moe
    smoke with remat on and off, bit for bit (phi3.5-moe at one thread:
    CPU ``index_put_`` accumulation is not repeatable across threads).
  * What the backwards re-run, counted at the dispatcher while a backward
    re-runs a block: ``full`` every block's 2-D products but its dead
    tail (the down projection, which the reference's remat drops too) in
    each of the two backwards, ``dots`` none of them but the attention's
    products, ``remat=False`` nothing.
  * Each family's ``remat_blocks`` is the number of blocks its training
    loss checkpoints, on every arch.
  * ``tap.carry()`` after both backwards is the forward's; the
    ``vmap(grad)`` oracle runs a remat config plainly; a smoke dry-run's
    liveness peak is lower under ``full`` than without remat; the policy
    name is checked, and a block that closes over its live tap refused.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import naive, passes
from repro_torch.core import taps
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.nn.param import tree_flatten, tree_leaves, tree_unflatten

RTOL = 1e-4
B, S = 3, 12
SIGMA, CLIP = 0.1, 1.0
SETTINGS = {"full": {"remat": True, "remat_policy": "full"},
            "dots": {"remat": True, "remat_policy": "dots"},
            "off": {"remat": False}}


def _cfg(spec, name):
    kw = dict(SETTINGS[name])
    if not hasattr(spec.smoke(), "remat_policy"):
        kw.pop("remat_policy", None)
    return dataclasses.replace(spec.smoke(), **kw)


@pytest.fixture(scope="module")
def llama():
    """The port's llama3.2-1b smoke parameters (seed 0) as the
    reference's, its batch, its jitted
    [Norms, Clip, Noise, GNS] step with its default remat, and the noise
    sample it drew (``repro.core.passes.add_grad_noise``'s draw: one key a
    gradient leaf, split from the Noise's); the port's parameters and
    batch from the same numpy arrays."""
    jspec = jreg.get("llama3.2-1b")
    jcfg = jspec.smoke()
    assert jcfg.remat and jcfg.remat_policy == "full"
    spec = registry.get("llama3.2-1b")
    params = registry.family_module(spec).init(
        spec.smoke(), torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     interop.params_to_numpy(params))
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    jloss = jreg.make_loss_fn_v2(jspec, jcfg)
    eng = jpex.Engine(jpex.PexSpec())
    key = jax.random.PRNGKey(5)
    noisy = jax.jit(lambda p, b: eng.step(
        jloss, p, b, [jpex.Norms(), jpex.Clip(CLIP), jpex.Noise(SIGMA, key),
                      jpex.GNS()]))(jparams, jbatch)
    flat, treedef = jax.tree_util.tree_flatten(noisy.grads)
    sample = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.normal(k, g.shape, jnp.float32).astype(g.dtype))
        for g, k in zip(flat, jax.random.split(key, len(flat)))])
    batch = registry.make_train_batch(spec, spec.smoke(),
                                      ShapeSpec("t", "train", S, B), 3,
                                      device="cpu")
    return dict(spec=spec, params=params, batch=batch, noisy=noisy,
                sample=interop.params_from_numpy(sample, device="cpu"))


def _inject(monkeypatch, sample):
    """Every noise draw of the next step is ``sample``'s next leaf."""
    draws = tree_flatten(sample)[0]

    def injected(shape, generator, device):
        d = draws.pop(0).clone()        # the noise add scales it in place
        assert tuple(d.shape) == tuple(shape)
        return d
    monkeypatch.setattr(passes, "_standard_normal", injected)
    return draws


def _step(st, name, granularity="example"):
    spec = st["spec"]
    loss = registry.make_loss_fn_v2(spec, _cfg(spec, name))
    if granularity == "token":
        cons = [pex.Clip(CLIP, granularity="token"),
                pex.Noise(SIGMA, torch.Generator(), scale=CLIP)]
    else:
        cons = [pex.Norms(), pex.Clip(CLIP), pex.Noise(SIGMA,
                                                       torch.Generator()),
                pex.GNS()]
    return pex.Engine(pex.PexSpec(), granularity=granularity).step(
        loss, st["params"], st["batch"], cons)


def _equal(a, b):
    ga, gb = tree_leaves(a.grads), tree_leaves(b.grads)
    return (torch.equal(a.loss_vec, b.loss_vec)
            and torch.equal(a.sq_norms, b.sq_norms)
            and len(ga) == len(gb)
            and all(torch.equal(x, y) for x, y in zip(ga, gb)))


@pytest.mark.parametrize("granularity", ["example", "token"])
def test_settings_bit_identical(llama, monkeypatch, granularity):
    """full, dots and remat=False: the same bits, the same injected
    sample added to each."""
    out = {}
    for name in SETTINGS:
        draws = _inject(monkeypatch, llama["sample"])
        out[name] = _step(llama, name, granularity)
        assert draws == []
    assert _equal(out["full"], out["dots"])
    assert _equal(out["full"], out["off"])


def _close_trees(port_tree, jax_tree):
    got = interop.params_to_numpy(port_tree)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = flat_want[path]
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_matches_reference_with_remat(llama, monkeypatch, name):
    """Each setting against the reference's jitted step with remat on."""
    _inject(monkeypatch, llama["sample"])
    t = _step(llama, name)
    want = llama["noisy"]
    for got, ref in ((t.loss_vec, want.loss_vec), (t.sq_norms, want.sq_norms),
                     (t.clip_coef, want.clip_coef), (t.gns, want.gns)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=1e-6)
    _close_trees(t.grads, want.grads)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b",
                                  "seamless-m4t-medium", "phi3.5-moe"])
def test_families_remat_bit_identical(arch):
    spec = registry.get(arch)
    params = registry.family_module(spec).init(
        spec.smoke(), torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, spec.smoke(),
                                      ShapeSpec("t", "train", 8, 2), 1,
                                      device="cpu")
    threads = torch.get_num_threads()
    if arch == "phi3.5-moe":
        torch.set_num_threads(1)
    try:
        out = {}
        for name in ("full", "off"):
            cfg = _cfg(spec, name)
            assert cfg.remat == (name == "full")
            out[name] = pex.Engine(pex.PexSpec()).step(
                registry.make_loss_fn_v2(spec, cfg), params, batch,
                [pex.Clip(CLIP), pex.Noise(SIGMA, torch.Generator()
                                           .manual_seed(2))])
    finally:
        torch.set_num_threads(threads)
    assert _equal(out["full"], out["off"])


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_remat_blocks_is_what_the_loss_checkpoints(arch, monkeypatch):
    """Each family's ``remat_blocks(cfg)`` (what ``chip_smoke.py`` counts
    the recompute's launches from) equals the blocks its training loss
    runs through ``taps.checkpoint``, and is 0 with remat off."""
    spec = registry.get(arch)
    mod = registry.family_module(spec)
    calls = []
    checkpoint = taps.checkpoint

    def counting(fn, **kw):
        inner = checkpoint(fn, **kw)

        def block(*a, **k):
            calls.append(fn)
            return inner(*a, **k)
        return block
    monkeypatch.setattr(taps, "checkpoint", counting)
    params = mod.init(spec.smoke(), torch.Generator().manual_seed(0),
                      device="cpu")
    batch = registry.make_train_batch(spec, spec.smoke(),
                                      ShapeSpec("t", "train", 8, 2), 1,
                                      device="cpu")
    for name in ("full", "off"):
        cfg = _cfg(spec, name)
        calls.clear()
        acc = taps.ExampleLayout(1).init(2, "cpu").requires_grad_()
        mod.loss_fn(params, batch, taps.Tap(taps.PexSpec(), acc), cfg=cfg)
        assert len(calls) == mod.remat_blocks(cfg), name
    assert mod.remat_blocks(_cfg(spec, "full")) > 0


class _Recomputed(TorchDispatchMode):
    """Counts, by aten op, what runs while a backward re-runs a block."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if taps.recomputing():
            self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_what_the_backwards_rerun(llama, name):
    spec = llama["spec"]
    cfg = _cfg(spec, name)
    loss = registry.make_loss_fn_v2(spec, cfg)
    with _Recomputed() as rec:
        res = pex.Engine(pex.PexSpec()).step(
            loss, llama["params"], llama["batch"],
            [pex.Clip(CLIP), pex.Grads()])
    assert res.grads is not None
    blocks, backwards = cfg.n_layers, 2
    products = 7 - 1            # q, k, v, o, gate, up; the down tail is dead
    want_mm = {"full": blocks * backwards * products, "dots": 0, "off": 0}
    want_bmm = {"full": blocks * backwards * 2, "dots": blocks * backwards * 2,
                "off": 0}       # the attention's scores and values
    assert rec.ops["mm"] == want_mm[name]
    assert rec.ops["bmm"] == want_bmm[name]
    if name == "off":
        assert not rec.ops


def test_carry_after_the_backwards_is_the_forwards(llama):
    """Two backwards over one graph (norms, then gradients), each
    re-running every block: the tap's accumulator is the forward's
    throughout, and the stats equal those without remat."""
    spec = llama["spec"]
    leaves, treedef = tree_flatten(llama["params"])
    sq = {}
    for name in ("full", "off"):
        loss = registry.make_loss_fn_v2(spec, _cfg(spec, name))
        ps = [x.detach().requires_grad_() for x in leaves]
        acc0 = taps.ExampleLayout(1).init(B, "cpu").requires_grad_()
        tap = taps.Tap(taps.PexSpec(), acc0)
        lv, _ = loss(tree_unflatten(treedef, ps), llama["batch"], tap)
        carry = tap.carry()
        tap.set_mode(norms=True, grads=False)
        (sq[name],) = torch.autograd.grad(lv, [acc0], torch.ones_like(lv),
                                          retain_graph=True)
        assert tap.carry() is carry
        tap.set_mode(norms=False, grads=True)
        torch.autograd.grad(lv, ps, torch.ones_like(lv), allow_unused=True)
        assert tap.carry() is carry
    assert torch.equal(sq["full"], sq["off"])


def test_vmap_grad_oracle_runs_a_remat_config(llama):
    """Under ``torch.func`` the checkpoint is the plain call (saved-tensor
    hooks are refused there); the oracle's norms match the fused ones."""
    spec = llama["spec"]
    cfg = _cfg(spec, "full")
    loss = registry.make_loss_fn_v2(spec, cfg)

    def single(p, ex):
        return loss(p, {k: v[None] for k, v in ex.items()}, pex.NULL)[0][0]
    oracle = naive.per_example_sq_norms(single, llama["params"],
                                        llama["batch"])
    got = pex.Engine(pex.PexSpec()).step(loss, llama["params"],
                                         llama["batch"], [pex.Norms()])
    assert float(torch.max(torch.abs(got.sq_norms.sum(-1) - oracle)
                           / oracle)) < 1e-4


def test_dryrun_liveness_falls_under_remat():
    """A smoke record at a sequence long enough for the blocks'
    activations to outweigh the head: the peak under full is lower."""
    spec = registry.get("llama3.2-1b")
    cons = [pex.Norms(), pex.Grads()]
    total = {}
    for name in ("full", "dots", "off"):
        cfg = dataclasses.replace(_cfg(spec, name), n_layers=4)
        tt, _ = dryrun.record_train(spec, cfg, 4, 128, consumers=cons)
        total[name] = dryrun.train_liveness(tt).total
    assert total["full"] < total["dots"] < total["off"]


def test_policy_and_tap_argument_are_checked():
    with pytest.raises(ValueError, match="remat policy"):
        taps.checkpoint(lambda x: x, policy="everything")
    # a live tap is an argument of the block, never closed over
    tap = taps.Tap(taps.PexSpec(),
                   taps.ExampleLayout(1).init(2, "cpu").requires_grad_())
    w = torch.ones(3, 3, requires_grad=True)
    with pytest.raises(ValueError, match="takes its live tap"):
        taps.checkpoint(lambda x: tap.dense(x, w), tap=tap)(torch.ones(2, 3))
    z = taps.checkpoint(lambda x, t: t.dense(x, w), tap=tap)(
        torch.ones(2, 3), tap)
    assert z.shape == (2, 3) and tap.carry().grad_fn is not None
    spec = registry.get("llama3.2-1b")
    serve = registry.serving_config(spec, spec.smoke(),
                                    ShapeSpec("s", "decode", 16, 1))
    assert serve.remat is False
