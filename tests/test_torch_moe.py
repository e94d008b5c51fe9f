"""The port's MoE path against the JAX reference's.

Covered: the segmented estimator (``stat_direct_segmented``: the port's
``xla`` oracle and its kernel route, which on the CPU runs the plain
version of ``kernels.ops.segmented_norm``) against the reference's ``xla``
form and its Pallas kernel in interpret mode, on fuzz cases and the edge
cases of ``tests/test_segmented.py``; ``nn.moe`` routing and forward; the
expert taps' dx, dW and stat against the reference's custom_vjp backward
rules; and the phi3.5-moe smoke ``Engine.step`` at ``dispatch_groups`` 1
and 2 (capacity drops included), parameters carried over by
``repro_torch.interop``, batch from the same numpy seed. The port's norms
are also held against a naive per-example loop at ``capacity_factor=8``,
where routing does not depend on the batch.

Tolerances: f32, 1e-5 relative for the estimators and single ops
(summation order); 1e-4 for the step (layers of reductions in another
order), as in ``tests/test_torch_llama_step.py``.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.core import norms as jN
from repro.core import passes as jpasses
from repro.core import taps as jT
from repro.models import registry as jreg
from repro.nn import moe as jmoe
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import norms as tN
from repro_torch.core import passes
from repro_torch.core import taps as tT
from repro_torch.kernels import ops as tops
from repro_torch.kernels.direct_norm import flop_estimate as tdn_est
from repro_torch.kernels.gram_norm import flop_estimate as tgn_est
from repro_torch.kernels import segmented_norm as tsn
from repro_torch.models import registry
from repro_torch.nn import moe as tmoe
from repro_torch.nn.param import tree_flatten, tree_unflatten

RTOL = 1e-5
STEP_RTOL = 1e-4
ARCH = "phi3.5-moe"
B, S = 4, 12
GROUPS = ("attn", "moe", "norm", "embed", "head")


def _naive(h, z, seg, n):
    """Numpy oracle: every segment's partial gradient, materialized."""
    h = np.asarray(h, np.float64)
    z = np.asarray(z, np.float64)
    seg = np.asarray(seg)
    out = np.zeros((n,))
    for j in range(n):
        g = h[seg == j].T @ z[seg == j]
        out[j] = np.sum(g * g)
    return out


def _case(seed, t, p_in, p_out, n, drop_frac=0.2):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, p_in)).astype(np.float32)
    z = rng.normal(size=(t, p_out)).astype(np.float32)
    seg = rng.integers(0, n, size=(t,))
    dropped = rng.random(t) < drop_frac
    seg = np.where(dropped, n + rng.integers(0, 7, size=(t,)), seg)
    return h, z, seg.astype(np.int32)


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _all_routes(h, z, seg, n, pallas=True, **kw):
    """{route: (n,) stat} for the reference's xla route (and its Pallas
    kernel in interpret mode, ~3.5 s a shape here) and the port's xla and
    kernel routes (and ``ops.segmented_norm`` directly)."""
    jh, jz, js = jnp.asarray(h), jnp.asarray(z), jnp.asarray(seg)
    th, tz, ts = (torch.from_numpy(np.asarray(a)) for a in (h, z, seg))
    out = {
        "ref_xla": np.asarray(jN.stat_direct_segmented(jh, jz, js, n,
                                                       method="xla", **kw)),
        "port_xla": tN.stat_direct_segmented(th, tz, ts, n, method="xla",
                                             **kw),
        "port_kernel": tN.stat_direct_segmented(th, tz, ts, n,
                                                method="kernel", **kw),
        "ops": tops.segmented_norm(th, tz, ts, n),
    }
    if pallas:
        out["ref_pallas"] = np.asarray(jN.stat_direct_segmented(
            jh, jz, js, n, method="pallas", **kw))
    return out


# ---------------------------------------------------------------------------
# the segmented estimator
# ---------------------------------------------------------------------------

# (T, p_in, p_out, n, against the reference's Pallas kernel too)
FUZZ = [(7, 3, 5, 2, False), (130, 12, 40, 9, False),
        (100, 140, 36, 3, False), (33, 260, 7, 33, True),
        (129, 64, 129, 1, True)]


@pytest.mark.parametrize("t,p_in,p_out,n,pallas", FUZZ)
def test_segmented_routes_match_reference(t, p_in, p_out, n, pallas):
    """Ragged T, chunked p_in (> 128), one segment, many segments."""
    h, z, seg = _case(t * 1000 + p_in + p_out + n, t, p_in, p_out, n)
    want = _naive(h, z, seg, n)
    for route, got in _all_routes(h, z, seg, n, pallas).items():
        assert got.shape == (n,), route
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                                   atol=1e-6, err_msg=route)


def _edge(name):
    rng = np.random.default_rng(5)
    if name == "all_rows_dropped":
        return (np.ones((48, 8), np.float32), np.ones((48, 4), np.float32),
                np.full((48,), 7, np.int32), 3, {})
    if name == "dropped_token_block":
        t, n = 96, 4
        seg = rng.integers(0, n, size=(t,)).astype(np.int32)
        seg[32:64] = n + 100   # one whole token block of drops
        return (rng.normal(size=(t, 10)).astype(np.float32),
                rng.normal(size=(t, 6)).astype(np.float32), seg, n,
                {"token_block": 32})
    if name == "single_example":
        seg = np.zeros((40,), np.int32)
        seg[::3] = 9
        return (rng.normal(size=(40, 12)).astype(np.float32),
                rng.normal(size=(40, 8)).astype(np.float32), seg, 1, {})
    if name == "empty_segments":
        return (rng.normal(size=(16, 6)).astype(np.float32),
                rng.normal(size=(16, 5)).astype(np.float32),
                np.full((16,), 2, np.int32), 5, {})
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all_rows_dropped", "dropped_token_block",
                                  "single_example", "empty_segments"])
def test_segmented_edge_cases(name):
    h, z, seg, n, kw = _edge(name)
    want = _naive(h, z, seg, n)
    for route, got in _all_routes(h, z, seg, n,
                                  name == "all_rows_dropped", **kw).items():
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                                   atol=1e-6, err_msg=route)
        # an empty segment, and every segment when all rows drop, is 0
        np.testing.assert_array_equal(np.asarray(got)[want == 0], 0.0,
                                      err_msg=route)


def test_segmented_degenerate_sizes():
    z4, z3, i0 = torch.zeros((0, 4)), torch.zeros((0, 3)), \
        torch.zeros((0,), dtype=torch.int32)
    for method in ("xla", "kernel"):
        got = tN.stat_direct_segmented(z4, z3, i0, 2, method=method)
        _close(got, np.zeros((2,)))
        assert tN.stat_direct_segmented(torch.ones((4, 4)),
                                        torch.ones((4, 3)),
                                        torch.zeros((4,), dtype=torch.int32),
                                        0, method=method).shape == (0,)
    assert tops.segmented_norm(torch.ones((3, 0)), torch.ones((3, 2)),
                               torch.zeros((3,)), 2).tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="segmented"):
        tN.stat_direct_segmented(torch.ones((2, 2)), torch.ones((2, 2)),
                                 torch.zeros((2,)), 1, method="pallas")


def test_csr_sorts_rows_and_drops_out_of_range_ids():
    """Ids ≥ n_seg and negative ids go to the drop bucket after the last
    segment; the sort is stable."""
    order, offsets = tsn.csr(torch.tensor([3, 0, 2, 0, 9, -1, 2, 1]), 3)
    assert order.dtype == offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 3, 5]
    assert order[:5].tolist() == [1, 3, 7, 2, 6]


def test_segmented_wrapper_rejects_other_devices():
    """No plain-version fallback for tensors off the CPU; the CUDA
    launcher refuses CPU tensors."""
    seg = torch.zeros(8, dtype=torch.long)
    h, z = torch.empty(8, 4, device="meta"), torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError):
        tops.segmented_norm(h, z, seg.to("meta"), 2)
    with pytest.raises(ValueError):
        tops.segmented_norm(torch.zeros(8, 4), z, seg, 2)
    with pytest.raises(ValueError):
        tsn.segmented_norm(torch.zeros(8, 4), torch.zeros(8, 3), seg, 2)


def test_segmented_work_estimates():
    """The kernels' own work follows each segment's route: 27 rows take the
    gram route, one pair of 64-row tiles over 64-feature chunks (padding
    included); 5,000 rows (past the crossover, 4,931) the direct form over
    its kept rows. The bytes count the kept rows of h and z̄, the ids and
    the output, never a dropped row."""
    pi, po = 4096, 6400
    seg = torch.tensor([0] * 27 + [2] * 5000 + [9] * 40 + [-1] * 3)
    assert tsn.segment_sizes(seg, 3).tolist() == [27, 0, 5000]
    assert tsn.flop_estimate(seg, 3, pi, po) == \
        2.0 * 64 * 64 * (pi + po + 1) + 2.0 * 5000 * pi * po + 2.0 * pi * po
    assert tsn.bytes_estimate(seg, 3, pi, po, 2) == \
        5027 * (pi + po) * 2 + seg.numel() * 8 + 3 * 4


def test_segmented_least_work_takes_the_cheaper_form_per_segment():
    """Each segment is priced at the fewer operations of the gram and the
    direct form (``ops.flop_estimate`` on a one-example problem): the gram
    form for a few dozen rows, the direct form for thousands; an empty
    segment costs nothing."""
    pi, po = 4096, 6400
    seg = torch.tensor([0] * 27 + [2] * 5000 + [7] * 11)
    gram = 2.0 * 27 * 27 * (pi + po + 1)
    direct = 2.0 * 5000 * pi * po + 2.0 * pi * po
    assert tgn_est(1, 27, pi, po) == gram < tdn_est(1, 27, pi, po)
    assert tdn_est(1, 5000, pi, po) == direct < tgn_est(1, 5000, pi, po)
    assert tops.segmented_flop_estimate(seg, 3, pi, po) == gram + direct
    # the kernels' gram route pads 27 rows to a 64-row tile: 64²/27² more
    assert tsn.flop_estimate(seg[:27], 3, pi, po) == \
        tops.segmented_flop_estimate(seg[:27], 3, pi, po) * 64 ** 2 / 27 ** 2


def test_grouped_composite_parity():
    """The port's flattened (group, expert, example) composite — padding
    rows in the drop bucket, one call for all groups — against the
    reference's per-group vmap (xla) and its flattened Pallas route."""
    rng = np.random.default_rng(8)
    ng, e, c, d, f, bg = 2, 3, 8, 10, 6, 4
    x = rng.normal(size=(ng, e, c, d)).astype(np.float32)
    z = rng.normal(size=(ng, e, c, f)).astype(np.float32)
    seg = rng.integers(0, bg + 1, size=(ng, e, c)).astype(np.int32)
    acc = np.zeros((ng * bg, 2), np.float32)
    layout = jT.ExampleLayout(2)
    want = {m: np.asarray(layout.add_expert_grouped(
        jnp.asarray(acc), jnp.asarray(x), jnp.asarray(z), jnp.asarray(seg),
        None, 1, bg, m, m == "pallas")) for m in ("xla", "pallas")}
    np.testing.assert_allclose(want["pallas"], want["xla"], rtol=RTOL)
    for use_kernels in (False, True):
        got = tT.ExampleLayout(2).add_expert_grouped(
            torch.from_numpy(acc), torch.from_numpy(x), torch.from_numpy(z),
            torch.from_numpy(seg).long(), 1, bg, use_kernels)
        _close(got, want["xla"])


# ---------------------------------------------------------------------------
# nn.moe: routing and forward
# ---------------------------------------------------------------------------

def _moe_cfgs(ng, capacity_factor):
    kw = dict(d_model=16, d_ff=24, n_experts=4, top_k=2, renorm_topk=True,
              dispatch_groups=ng, capacity_factor=capacity_factor)
    return jmoe.MoeCfg(**kw), tmoe.MoeCfg(**kw)


@pytest.mark.parametrize("ng,capacity_factor", [(1, 1.25), (2, 0.5)])
def test_moe_forward_matches_reference(ng, capacity_factor):
    """Routing first (a top-k near-tie would show here, not as a forward
    mismatch), then the dispatch/combine forward; 0.5 forces drops."""
    jcfg, tcfg = _moe_cfgs(ng, capacity_factor)
    jp = unbox(jmoe.init_moe(jax.random.PRNGKey(1), jcfg,
                             dtype=jnp.float32))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    x = np.random.default_rng(2).normal(size=(4, 6, 16)).astype(np.float32)
    logits = x.reshape(-1, 16) @ np.asarray(jp["router"]["w"])
    jg, ji = jmoe._route(jcfg, jnp.asarray(logits))
    tg, ti = tmoe._route(tcfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    want = jax.jit(lambda p, x: jmoe.moe(p, x, tap=jT.NULL, cfg=jcfg))(
        jp, jnp.asarray(x))
    got = tmoe.moe(tp, torch.from_numpy(x), tap=tT.NULL, cfg=tcfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# expert taps: dx, dW and the accumulator cotangent vs the reference's bwd
# ---------------------------------------------------------------------------

def _expert_inputs(ng, e, c, d, f, bg, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ng, e, c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    zbar = rng.normal(size=(ng, e, c, f)).astype(np.float32)
    seg = rng.integers(0, bg + 2, size=(ng, e, c)).astype(np.int32)
    acc_bar = rng.normal(size=(ng * bg, 3)).astype(np.float32)
    return x, w, zbar, seg, acc_bar


def _port_expert(x, w, zbar, seg, acc_bar, bg, use_kernels, *,
                 grouped=True):
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    acc = torch.zeros(acc_bar.shape, requires_grad=True)
    tap = tT.Tap(tT.PexSpec(groups=("attn", "moe", "all"),
                            use_kernels=use_kernels), acc=acc)
    seg = torch.from_numpy(seg).long()
    z = tap.dense_expert_grouped(x, w, seg, bg) if grouped \
        else tap.dense_expert(x, w, seg)
    return torch.autograd.grad([z, tap.carry()], [x, w, acc],
                               [torch.from_numpy(zbar),
                                torch.from_numpy(acc_bar)])


@pytest.mark.parametrize("use_kernels", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("ng,bg", [(1, 3), (2, 2), (2, 3)])
def test_dense_expert_grouped_bwd_matches_reference(ng, bg, use_kernels):
    """Group-local ids with padding rows (id ≥ bg) in every group."""
    x, w, zbar, seg, acc_bar = _expert_inputs(ng, 3, 7, 5, 4, bg, ng + bg)
    dx, dw, _, _, dacc = jT._pex_dense_expert_grouped_bwd(
        1, bg, "xla", False, jT.ExampleLayout(3),
        tuple(map(jnp.asarray, (x, w, seg, np.full_like(seg, -1)))),
        (jnp.asarray(zbar), jnp.asarray(acc_bar)))
    tx, tw, tacc = _port_expert(x, w, zbar, seg, acc_bar, bg, use_kernels)
    _close(tx, dx)
    _close(tw, dw)
    _close(tacc, dacc)


def test_dense_expert_bwd_matches_reference():
    x, w, zbar, seg, acc_bar = _expert_inputs(1, 3, 8, 6, 5, 4, 12)
    res = tuple(map(jnp.asarray, (x[0], w, seg[0], np.full_like(seg[0], -1))))
    dx, dw, _, _, dacc = jT._pex_dense_expert_bwd(
        1, 4, "xla", False, jT.ExampleLayout(3), res,
        (jnp.asarray(zbar[0]), jnp.asarray(acc_bar)))
    tx, tw, tacc = _port_expert(x[0], w, zbar[0], seg[0], acc_bar, 4, True,
                                grouped=False)
    _close(tx, dx)
    _close(tw, dw)
    _close(tacc, dacc)
    layout = tT.ExampleLayout(3)
    _close(layout.add_expert(torch.from_numpy(acc_bar),
                             torch.from_numpy(x[0]), torch.from_numpy(zbar[0]),
                             torch.from_numpy(seg[0]).long(), 1, False),
           dacc)


@pytest.mark.parametrize("norms,grads", [(True, False), (False, True)])
def test_expert_backward_mode(norms, grads):
    """A norms-only backward forms no expert dW; a gradient-only one runs
    no segmented stat."""
    x, w, _, seg, _ = _expert_inputs(2, 3, 5, 4, 3, 2, 3)
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    acc = torch.zeros(4, 1, requires_grad=True)
    tap = tT.Tap(tT.PexSpec(), acc=acc)
    z = tap.dense_expert_grouped(x, w, torch.from_numpy(seg).long(), 2)
    tap.set_mode(norms=norms, grads=grads)
    gx, gw, gacc = torch.autograd.grad(z.sum(), [x, w, acc],
                                       allow_unused=True)
    assert gx is not None
    assert (gw is not None) == grads
    assert (gacc is not None) == norms


# ---------------------------------------------------------------------------
# the phi3.5-moe smoke step
# ---------------------------------------------------------------------------

def _cfg_edit(cfg, ng, capacity_factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=ng, capacity_factor=capacity_factor))


@pytest.fixture(scope="module", params=[(1, 1.25), (2, 0.5)],
                ids=["ng1", "ng2_drops"])
def setup(request):
    ng, cf = request.param
    jspec = jreg.get(ARCH)
    jcfg = _cfg_edit(jspec.smoke(), ng, cf)
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    spec = registry.get(ARCH)
    cfg = _cfg_edit(spec.smoke(), ng, cf)
    return dict(jloss=jreg.make_loss_fn_v2(jspec, jcfg), jparams=jparams,
                jbatch=jbatch, np_params=np_params, cfg=cfg,
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
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_params_round_trip(setup):
    """The (L, E, d, f) expert leaves and the f32 router carry over and
    back unchanged."""
    blocks = setup["params"]["blocks"]
    assert len(blocks) == setup["cfg"].n_layers
    moe_p = blocks[0]["moe"]
    m = setup["cfg"].moe
    assert moe_p["gate"].shape == (m.n_experts, m.d_model, m.d_ff)
    assert moe_p["down"].shape == (m.n_experts, m.d_ff, m.d_model)
    assert moe_p["router"]["w"].dtype == torch.float32
    _close_trees(setup["params"], setup["np_params"], rtol=0)


def test_step_clip_noise_gns_match(setup, monkeypatch):
    """Both packages add the same N(0, 1) sample: the reference's own draw
    for the step's key (its noise pass on zero gradients, σ = C = 1) is
    handed to the port."""
    sigma, c = 0.1, 1.0
    key = jax.random.PRNGKey(5)
    eng = jpex.Engine(jpex.PexSpec(groups=GROUPS))
    noisy = jax.jit(lambda p, b: eng.step(
        setup["jloss"], p, b,
        [jpex.Norms(), jpex.Clip(c), jpex.Noise(sigma, key), jpex.GNS()]))(
            setup["jparams"], setup["jbatch"])
    sample = jax.jit(lambda g: jpasses.add_grad_noise(
        jax.tree_util.tree_map(jnp.zeros_like, g), 1.0, 1.0, key))(
            noisy.grads)
    draws = tree_flatten(interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, sample), device="cpu"))[0]

    def injected(shape, generator, device):
        d = draws.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return d

    monkeypatch.setattr(passes, "_standard_normal", injected)
    t = pex.Engine(pex.PexSpec(groups=GROUPS)).step(
        setup["loss"], setup["params"], setup["batch"],
        [pex.Norms(), pex.Clip(c), pex.Noise(sigma, torch.Generator()),
         pex.GNS()])
    assert draws == []
    _close(t.loss_vec, noisy.loss_vec, rtol=STEP_RTOL)
    _close(t.sq_norms, noisy.sq_norms, rtol=STEP_RTOL)
    assert float(t.sq_norms[:, GROUPS.index("moe")].min()) > 0
    _close(t.clip_coef, noisy.clip_coef, rtol=STEP_RTOL)
    _close(t.gns, noisy.gns, rtol=STEP_RTOL)
    _close_trees(t.grads, noisy.grads)


def test_step_routes_and_counts(setup, monkeypatch):
    """Every expert tap's stat goes through ``ops.segmented_norm`` on the
    kernel route (3 per layer, the norms backward only, each one launch
    over all ng·E·bg composite segments) and through none without
    ``use_kernels`` (the scan/segment-sum oracle); both give the same
    norms."""
    calls = []
    seg_norm = tops.segmented_norm

    def counted(h, zbar, seg_ids, n_seg):
        calls.append(n_seg)
        return seg_norm(h, zbar, seg_ids, n_seg)

    monkeypatch.setattr(tops, "segmented_norm", counted)
    m = setup["cfg"].moe
    n_seg = m.n_experts * B   # ng groups × E experts × B/ng examples
    res = {}
    for use_kernels, want in ((True, [n_seg] * 3 * setup["cfg"].n_layers),
                              (False, [])):
        calls.clear()
        res[use_kernels] = pex.Engine(
            pex.PexSpec(use_kernels=use_kernels)).step(
            setup["loss"], setup["params"], setup["batch"],
            [pex.Norms(), pex.Clip(1.0)])
        assert calls == want, use_kernels
    _close(res[True].sq_norms, res[False].sq_norms.numpy())


def test_tree_unflatten_frees_its_leaves():
    """Building a tree leaves no reference cycle behind: the leaves of a
    step's gradient tree are freed when the tree is, not when the cyclic
    collector runs (a full-width run held ~27 GiB of an earlier phase's
    trees that way)."""
    leaves, treedef = tree_flatten({"a": [torch.zeros(3), torch.ones(2)],
                                    "b": (torch.zeros(1),)})
    gc.collect()
    gc.disable()
    try:
        tree = tree_unflatten(treedef, leaves)
        del tree
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_norms_match_naive_oracle():
    """At capacity_factor=8 no token is dropped, so routing does not depend
    on the batch: the fused norms equal a loop of single-example
    backward passes (max rel err < 1e-4), and the summed gradients of the
    same folded backward equal a plain batch backward."""
    spec = registry.get(ARCH)
    cfg = _cfg_edit(spec.smoke(), 2, 8.0)
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", 10,
                                                           4), 1, device="cpu")
    loss = registry.make_loss_fn_v2(spec, cfg)
    res = pex.Engine(pex.PexSpec()).step(loss, params, batch,
                                         [pex.Norms(), pex.Grads()])
    got = res.sq_norms.sum(-1)
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, leaves)
    gs = torch.autograd.grad(loss(p, batch, pex.NULL)[0].sum(), leaves)
    for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
        torch.testing.assert_close(g_eng, g, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * float(g.abs().max()))
    want = []
    for j in range(4):
        ex = {k: v[j:j + 1] for k, v in batch.items()}
        gs = torch.autograd.grad(loss(p, ex, pex.NULL)[0][0], leaves)
        want.append(sum(float(torch.sum(g * g)) for g in gs))
    want = torch.tensor(want)
    assert float(torch.max(torch.abs(got - want) / want)) < 1e-4
