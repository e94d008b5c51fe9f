"""The port's token granularity against the JAX reference's.

Covered: every ``TokenLayout`` stat (dense, bias, scale, embedding and the
expert slots, scattered through the dispatch's slot → token table) against
the reference's, with the ``rowsumsq`` route (``use_kernels``; on the CPU
the plain version of ``kernels.ops.rowsumsq``) and without it; the
llama3.2-1b smoke ``Engine(granularity="token").step`` (the (B, S) norm
map, the token clip coefficients and the token-weighted gradients), and
the same ``[Norms]`` and ``[Clip(2.0, token), Grads]`` steps of the
gemma2-9b (window 8 binding at S=12), qwen2-vl-7b (``seq=`` given),
qwen2-7b, minitron-4b, deepseek-v2-236b, rwkv6-3b, zamba2-7b and
seamless-m4t-medium smoke configs; the
phi3.5-moe smoke token step at ``dispatch_groups`` 1 and 2 (capacity drops
included); the passes' division of work (``rowsumsq`` calls in the norms
backward only); and ``analyze``'s token errors. Parameters are carried
over by ``repro_torch.interop``, batches drawn from the same numpy seed.

Tolerances: f32, 1e-5 relative for the layout stats (summation order);
1e-4 for the steps (layers of reductions in another order), as in
``tests/test_torch_llama_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import taps as jT
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import passes
from repro_torch.core import plan as plan_mod
from repro_torch.core import taps as tT
from repro_torch.kernels import ops as tops
from repro_torch.models import registry
from repro_torch.nn.param import tree_flatten

RTOL = 1e-5
STEP_RTOL = 1e-4
B, S = 3, 12


def _arrays(*shapes, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _count_rowsumsq(monkeypatch):
    """Count the calls of ``kernels.ops.rowsumsq`` (the route under
    ``use_kernels``) into the returned list."""
    calls = []
    fn = tops.rowsumsq

    def counted(x, keep=1):
        calls.append(tuple(x.shape))
        return fn(x, keep)

    monkeypatch.setattr(tops, "rowsumsq", counted)
    return calls


# ---------------------------------------------------------------------------
# TokenLayout stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("op", ["dense", "bias", "scale", "embedding"])
def test_token_layout_stats_match_reference(op, use_kernels, monkeypatch):
    """Each stat against the reference's at 1e-5; under ``use_kernels``
    every per-token Σx² is one ``ops.rowsumsq`` call (two for a dense
    tap), without it none."""
    h, z, acc = _arrays((3, 7, 12), (3, 7, 5), (3, 7))
    calls = _count_rowsumsq(monkeypatch)
    jl, tl = jT.TokenLayout(7), tT.TokenLayout(7)
    ja, th, tz, ta = (jnp.asarray(acc), torch.from_numpy(h),
                      torch.from_numpy(z), torch.from_numpy(acc))
    if op == "dense":
        want = jl.add_dense(ja, jnp.asarray(h), jnp.asarray(z), 0, "auto",
                            False)
        got = tl.add_dense(ta, th, tz, 0, "auto", use_kernels)
    elif op == "bias":
        want = jl.add_bias(ja, jnp.asarray(z), 0)
        got = tl.add_bias(ta, tz, 0, use_kernels)
    elif op == "scale":
        want = jl.add_scale(ja, jnp.asarray(h), jnp.asarray(h[..., ::-1]), 0)
        got = tl.add_scale(ta, th, th.flip(-1), 0, use_kernels)
    else:
        ids = np.random.default_rng(3).integers(0, 9, (3, 7))
        want = jl.add_embedding(ja, jnp.asarray(ids), jnp.asarray(z), 0)
        got = tl.add_embedding(ta, torch.from_numpy(ids), tz, 0, use_kernels)
    _close(got, want)
    n_calls = 2 if op == "dense" else 1
    assert len(calls) == (n_calls if use_kernels else 0)


def test_token_layout_rejects_rank2():
    """A rank-2 activation would broadcast into the (B, S) map: raise, as
    the reference does."""
    h, z, acc = (torch.from_numpy(a) for a in _arrays((3, 7), (3, 5), (3, 7)))
    tl = tT.TokenLayout(7)
    with pytest.raises(ValueError, match="dense tap needs"):
        tl.add_dense(acc, h, z, 0, "auto", True)
    for op, args in (("add_bias", (z,)), ("add_scale", (h, h)),
                     ("add_embedding", (None, z))):
        with pytest.raises(ValueError, match="needs \\(B, S, ...\\)"):
            getattr(tl, op)(acc, *args, 0, True)


def _slots(ng, e, c, tg, seed):
    """Expert buffers with a slot → token table: each token's slots land
    in distinct experts; about a fifth of the slots are padding (tok =
    tg, or -1)."""
    rng = np.random.default_rng(seed)
    x, z = (rng.normal(size=(ng, e, c, d)).astype(np.float32)
            for d in (6, 4))
    tok = rng.integers(0, tg, size=(ng, e, c))
    pad = rng.random((ng, e, c)) < 0.2
    tok = np.where(pad, np.where(rng.random((ng, e, c)) < 0.5, tg, -1), tok)
    return x, z, tok.astype(np.int32)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("ng,bg", [(1, 3), (2, 2)])
def test_token_layout_expert_stats_match_reference(ng, bg, use_kernels):
    """Per-slot ‖x‖²·‖z̄‖² scattered to each slot's token (padding slots
    dropped), grouped and non-grouped, against the reference at 1e-5."""
    s = 5
    x, z, tok = _slots(ng, 3, 8, bg * s, 4 + ng)
    (acc,) = _arrays((ng * bg, s), seed=9)
    seg = np.zeros_like(tok)
    want = jT.TokenLayout(s).add_expert_grouped(
        jnp.asarray(acc), jnp.asarray(x), jnp.asarray(z), jnp.asarray(seg),
        jnp.asarray(tok), 0, bg, "xla", False)
    got = tT.TokenLayout(s).add_expert_grouped(
        torch.from_numpy(acc), torch.from_numpy(x), torch.from_numpy(z),
        torch.from_numpy(seg), 0, bg, use_kernels,
        tok=torch.from_numpy(tok).long())
    _close(got, want)
    if ng == 1:
        want = jT.TokenLayout(s).add_expert(
            jnp.asarray(acc), jnp.asarray(x[0]), jnp.asarray(z[0]),
            jnp.asarray(seg[0]), jnp.asarray(tok[0]), 0, bg, "xla", False)
        got = tT.TokenLayout(s).add_expert(
            torch.from_numpy(acc), torch.from_numpy(x[0]),
            torch.from_numpy(z[0]), torch.from_numpy(seg[0]), 0,
            use_kernels, tok=torch.from_numpy(tok[0]).long())
        _close(got, want)


def test_expert_tap_needs_token_positions():
    """At token granularity an expert tap without a slot → token table
    raises; at example granularity it runs."""
    x = torch.zeros(1, 2, 4, 3)
    w = torch.zeros(2, 3, 5)
    seg = torch.zeros(1, 2, 4, dtype=torch.long)
    tap = tT.Tap(tT.PexSpec(), acc=torch.zeros(2, 4, requires_grad=True),
                 layout=tT.TokenLayout(4))
    with pytest.raises(ValueError, match="tok="):
        tap.dense_expert_grouped(x, w, seg, 2)
    tap = tT.Tap(tT.PexSpec(), acc=torch.zeros(2, 1, requires_grad=True))
    assert tap.dense_expert_grouped(x, w, seg, 2).shape == (1, 2, 4, 5)


# ---------------------------------------------------------------------------
# the llama3.2-1b smoke token step
# ---------------------------------------------------------------------------

def _setup(arch, edit=lambda cfg: cfg):
    jspec = jreg.get(arch)
    jcfg = edit(jspec.smoke())
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    spec = registry.get(arch)
    cfg = edit(spec.smoke())
    return dict(arch=arch, jloss=jreg.make_loss_fn_v2(jspec, jcfg),
                jparams=jparams,
                jbatch=jbatch, cfg=cfg,
                params=interop.params_from_numpy(np_params, device="cpu"),
                batch=registry.make_train_batch(
                    spec, cfg, ShapeSpec("t", "train", S, B), 3,
                    device="cpu"),
                loss=registry.make_loss_fn_v2(spec, cfg))


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


@pytest.fixture(scope="module")
def llama():
    return _setup("llama3.2-1b")


def _steps(st, consumers, jconsumers, granularity="token", **kw):
    t = pex.Engine(pex.PexSpec(), granularity=granularity).step(
        st["loss"], st["params"], st["batch"], consumers,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    j = jpex.Engine(jpex.PexSpec(), granularity=granularity).step(
        st["jloss"], st["jparams"], st["jbatch"], jconsumers,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    return t, j


def test_llama_token_norms_match(llama):
    t, j = _steps(llama, [pex.Norms()], [jpex.Norms()])
    assert t.sq_norms.shape == (B, S) and t.grads is None
    _close(t.loss_vec, j.loss_vec, STEP_RTOL)
    _close(t.sq_norms, j.sq_norms, STEP_RTOL)


def test_llama_token_clip_matches(llama):
    """[Clip(C, token), Grads()]: the (B, S) norms, the token clip
    coefficients (some below 1) and the token-weighted gradients."""
    t, j = _steps(llama, [pex.Clip(2.0, granularity="token"), pex.Grads()],
                  [jpex.Clip(2.0, granularity="token"), jpex.Grads()])
    _close(t.sq_norms, j.sq_norms, STEP_RTOL)
    _close(t.clip_coef, j.clip_coef, STEP_RTOL)
    _close(t.token_weights, j.token_weights, STEP_RTOL)
    assert t.weights is None
    assert 0 < float(t.clip_coef.min()) < 1.0
    _close_trees(t.grads, j.grads)


def test_llama_token_clip_with_loss_weights_and_noise(llama, monkeypatch):
    """User loss weights multiply the token seed (tw · w[:, None]), on an
    example-granularity engine as in ``examples/dp_sgd_clipping.py``; a
    Noise with an explicit scale then adds σ·scale times the sample."""
    w = np.array([0.5, 2.0, 1.0], np.float32)
    t, j = _steps(llama, [pex.Clip(2.0, granularity="token"), pex.Grads()],
                  [jpex.Clip(2.0, granularity="token"), jpex.Grads()],
                  granularity="example", loss_weights=w)
    _close(t.weights, j.weights)
    _close(t.token_weights, j.token_weights, STEP_RTOL)
    _close_trees(t.grads, j.grads)
    monkeypatch.setattr(passes, "_standard_normal",
                        lambda shape, generator, device: torch.full(
                            tuple(shape), 0.25))
    n = pex.Engine(pex.PexSpec()).step(
        llama["loss"], llama["params"], llama["batch"],
        [pex.Clip(2.0, granularity="token"),
         pex.Noise(0.1, torch.Generator(), scale=3.0)],
        loss_weights=torch.from_numpy(w))
    for a, b in zip(tree_flatten(n.grads)[0], tree_flatten(t.grads)[0]):
        torch.testing.assert_close(a, b + 0.1 * 3.0 * 0.25)


def test_llama_token_passes_divide_the_work(llama, monkeypatch):
    """In the token Clip plan the norms backward makes every per-token Σx²
    through ``ops.rowsumsq`` — 2 per dense tap, 1 per scale tap, 1 for the
    embedding — and the reweighted backward makes none; no gram or direct
    call in either."""
    calls = _count_rowsumsq(monkeypatch)
    norm_calls = []
    for name in ("gram_norm", "direct_norm", "segmented_norm"):
        monkeypatch.setattr(tops, name,
                            lambda *a, _n=name, **k: norm_calls.append(_n))
    per_pass = []
    grad = plan_mod._grad

    def counted_grad(*a, **kw):
        before = len(calls)
        out = grad(*a, **kw)
        per_pass.append(len(calls) - before)
        return out

    monkeypatch.setattr(plan_mod, "_grad", counted_grad)
    pex.Engine(pex.PexSpec(), granularity="token").step(
        llama["loss"], llama["params"], llama["batch"],
        [pex.Clip(0.5, granularity="token"), pex.Grads()])
    n_layers = llama["cfg"].n_layers
    dense, scale = 7 * n_layers + 1, 2 * n_layers + 1
    assert per_pass == [2 * dense + scale + 1, 0]
    assert norm_calls == []


def test_engine_tap_gives_the_token_map(llama):
    """A hand-rolled pass through ``Engine.tap``: the gradient of Σ loss
    w.r.t. the tap's initial accumulator is the engine's (B, S) map."""
    eng = pex.Engine(pex.PexSpec(), granularity="token")
    tap = eng.tap(B, seq=S, device="cpu")
    acc0 = tap.carry()
    lv, _ = llama["loss"](llama["params"], llama["batch"], tap)
    (got,) = torch.autograd.grad(lv.sum(), acc0)
    want = eng.step(llama["loss"], llama["params"], llama["batch"],
                    [pex.Norms()]).sq_norms
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="seq="):
        eng.tap(B, device="cpu")


# ---------------------------------------------------------------------------
# the other archs' smoke token steps
# ---------------------------------------------------------------------------

ARCHS = ("gemma2-9b", "qwen2-vl-7b", "qwen2-7b", "minitron-4b",
         "deepseek-v2-236b", "rwkv6-3b", "zamba2-7b", "seamless-m4t-medium")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _setup(request.param)


def _arch_steps(st, consumers, jconsumers):
    """Both packages' token steps, the reference's jitted. qwen2-vl's
    (B, 3, S) M-RoPE positions leave the sequence axis ambiguous, so its
    engines are given ``seq=``, as the reference's needs too."""
    seq = S if getattr(st["cfg"], "vl_inputs", False) else None
    t = pex.Engine(pex.PexSpec(), granularity="token").step(
        st["loss"], st["params"], st["batch"], consumers, seq=seq)
    eng = jpex.Engine(jpex.PexSpec(), granularity="token")
    j = jax.jit(lambda p, b: eng.step(st["jloss"], p, b, jconsumers,
                                      seq=seq))(st["jparams"], st["jbatch"])
    return t, j


def test_arch_token_norms_match(arch):
    """[Norms] at token granularity: the (B, S) norm map of gemma2-9b (its
    window of 8 binding at S=12), qwen2-vl-7b, qwen2-7b, minitron-4b,
    deepseek-v2-236b (MLA, the dense prefix, shared and routed experts),
    rwkv6-3b (the five mix_b slices' rows among the dense taps), zamba2-7b
    (the dt_bias bias tap; the shared block adds nothing) and
    seamless-m4t-medium (the encoder's taps see source-frame rows, and
    frame t's stat lands at token t, as in the reference)."""
    t, j = _arch_steps(arch, [pex.Norms()], [jpex.Norms()])
    assert t.sq_norms.shape == (B, S) and t.grads is None
    _close(t.loss_vec, j.loss_vec, STEP_RTOL)
    _close(t.sq_norms, j.sq_norms, STEP_RTOL)


def test_arch_token_clip_matches(arch):
    """[Clip(2.0, token), Grads()]: the (B, S) norms, the token clip
    coefficients (some below 1), the token weights and the token-weighted
    gradients."""
    t, j = _arch_steps(arch, [pex.Clip(2.0, granularity="token"),
                              pex.Grads()],
                       [jpex.Clip(2.0, granularity="token"), jpex.Grads()])
    _close(t.sq_norms, j.sq_norms, STEP_RTOL)
    _close(t.clip_coef, j.clip_coef, STEP_RTOL)
    _close(t.token_weights, j.token_weights, STEP_RTOL)
    assert 0 < float(t.clip_coef.min()) < 1.0
    _close_trees(t.grads, j.grads, TOKEN_GRAD_RTOL.get(arch["arch"],
                                                       STEP_RTOL))


#: rwkv6-3b's token-clipped gradients: a sum over tokens of c_t-weighted
#: terms that cancel, whose elements sit up to 1.6e-4 of their leaf's
#: largest |value| from the reference's in f32 — as far with the port's
#: plain per-step WKV loop under autograd as with its chunked recurrence,
#: so the distance is the f32 conditioning of this sum, not the port
TOKEN_GRAD_RTOL = {"rwkv6-3b": 2e-4}


# ---------------------------------------------------------------------------
# analyze's token errors
# ---------------------------------------------------------------------------

def test_analyze_token_errors(llama):
    tok_eng = pex.Engine(pex.PexSpec(), granularity="token")
    run = lambda eng, cs, **kw: eng.step(  # noqa: E731
        llama["loss"], llama["params"], llama["batch"], cs, **kw)
    with pytest.raises(ValueError, match="granularity='example'"):
        run(tok_eng, [pex.Clip(1.0)])
    with pytest.raises(NotImplementedError, match="GNS"):
        run(tok_eng, [pex.GNS()])
    with pytest.raises(NotImplementedError, match="GNS"):
        run(pex.Engine(), [pex.Clip(1.0, granularity="token"), pex.GNS()])
    with pytest.raises(NotImplementedError, match="token-granularity"):
        run(tok_eng, [pex.Importance(2, rng=torch.Generator())])
    with pytest.raises(ValueError, match="sensitivity"):
        run(tok_eng, [pex.Clip(1.0, granularity="token"),
                      pex.Noise(0.5, torch.Generator())])
    with pytest.raises(ValueError, match="sensitivity"):
        tok_eng.clipped_step(llama["loss"], llama["params"], llama["batch"],
                             clip_norm=1.0, noise_std=0.5,
                             rng=torch.Generator())
    with pytest.raises(ValueError, match="does not lead with"):
        run(tok_eng, [pex.Clip(1.0, granularity="token")], seq=S + 1)

    def no_map(params, batch, tap):
        return llama["loss"](params, batch, pex.NULL)[0] + \
            0.0 * tap.carry().sum(), {}

    with pytest.raises(ValueError, match="tap.token_loss"):
        tok_eng.step(no_map, llama["params"], llama["batch"],
                     [pex.Clip(1.0, granularity="token")])
    with pytest.raises(ValueError, match="seq="):
        tok_eng.step(llama["loss"], llama["params"], {"x": torch.zeros(B)},
                     [pex.Norms()])


# ---------------------------------------------------------------------------
# the phi3.5-moe smoke token step
# ---------------------------------------------------------------------------

def _moe_edit(ng, capacity_factor):
    def edit(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=ng, capacity_factor=capacity_factor))
    return edit


@pytest.fixture(scope="module", params=[(1, 1.25), (2, 0.5)],
                ids=["ng1", "ng2_drops"])
def moe(request):
    return _setup("phi3.5-moe", _moe_edit(*request.param))


def test_moe_token_step_matches(moe, monkeypatch):
    """The (B, S) map and the token-clipped gradients of the phi3.5-moe
    smoke step; every expert tap adds its slot stats through two
    ``rowsumsq`` calls in the norms backward."""
    calls = _count_rowsumsq(monkeypatch)
    t, j = _steps(moe, [pex.Norms(), pex.Clip(1.0, granularity="token"),
                        pex.Grads()],
                  [jpex.Norms(), jpex.Clip(1.0, granularity="token"),
                   jpex.Grads()])
    _close(t.loss_vec, j.loss_vec, STEP_RTOL)
    _close(t.sq_norms, j.sq_norms, STEP_RTOL)
    _close(t.clip_coef, j.clip_coef, STEP_RTOL)
    _close_trees(t.grads, j.grads)
    n_layers = moe["cfg"].n_layers
    # per layer: 4 attention + router dense taps, 3 expert taps (2 calls
    # each), 2 scale taps; then the head, ln_f and the embedding
    expert = [c for c in calls if len(c) == 4]
    assert len(expert) == 2 * 3 * n_layers
    assert len(calls) == n_layers * (2 * 5 + 2 * 3 + 2) + 2 + 1 + 1
