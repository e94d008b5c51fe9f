"""The port's estimators and tapped ops against the JAX reference's.

Every ``stat_*`` of ``repro_torch.core.norms``, its dispatch, and each
tapped op's backward (dh, dW and the stat it adds to the accumulator's
cotangent) are held against ``repro.core.norms`` and the reference's
custom_vjp backward rules on the same numpy inputs. Tolerance: f32, 1e-5
relative (summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import norms as jN
from repro.core import taps as jT
from repro_torch.core import norms as tN
from repro_torch.core import taps as tT

RTOL = 1e-5
RNG_SEED = 11


def _arrays(*shapes, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

STAT_SHAPES = [((4, 9), (4, 5)), ((3, 7, 12), (3, 7, 20)),
               ((2, 1, 6), (2, 1, 4)), ((2, 33, 40), (2, 33, 8))]


@pytest.mark.parametrize("name", ["stat_factorized", "stat_gram",
                                  "stat_direct"])
@pytest.mark.parametrize("shapes", STAT_SHAPES)
def test_pair_stats(name, shapes):
    h, z = _arrays(*shapes)
    want = getattr(jN, name)(jnp.asarray(h), jnp.asarray(z))
    got = getattr(tN, name)(torch.from_numpy(h), torch.from_numpy(z))
    _close(got, want)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_stat_direct_chunks(chunk):
    h, z = _arrays((2, 6, 13), (2, 6, 9))
    _close(tN.stat_direct(torch.from_numpy(h), torch.from_numpy(z), chunk),
           jN.stat_direct(jnp.asarray(h), jnp.asarray(z), chunk))


@pytest.mark.parametrize("shape", [(4, 9), (3, 7, 12), (2, 3, 4, 5)])
def test_rowsumsq_and_bias(shape):
    (x,) = _arrays(shape)
    _close(tN.rowsumsq(torch.from_numpy(x)), jN.rowsumsq(jnp.asarray(x)))
    _close(tN.stat_bias(torch.from_numpy(x)), jN.stat_bias(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(4, 9), (3, 7, 12)])
def test_stat_elementwise(shape):
    h, z = _arrays(shape, shape)
    _close(tN.stat_elementwise(torch.from_numpy(h), torch.from_numpy(z)),
           jN.stat_elementwise(jnp.asarray(h), jnp.asarray(z)))


@pytest.mark.parametrize("vocab", [3, 50])
def test_stat_embedding(vocab):
    """Repeated ids (vocab 3 ≪ S) exercise the segment sums."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, vocab, (3, 17))
    (z,) = _arrays((3, 17, 6))
    _close(tN.stat_embedding(torch.from_numpy(ids), torch.from_numpy(z)),
           jN.stat_embedding(jnp.asarray(ids, jnp.int32), jnp.asarray(z)))


def test_pick_method_matches_reference():
    """The logical cost model picks what the reference's XLA-side model
    picks, over shapes on both sides of the crossover."""
    for s in (1, 8, 64, 100, 512, 1024, 4096):
        for p_in, p_out in ((2048, 2048), (2048, 512), (2048, 8192),
                            (8192, 2048), (64, 128256), (24, 40)):
            assert tN.pick_method(s, p_in, p_out) == \
                jN.pick_method(s, p_in, p_out, use_pallas=False), \
                (s, p_in, p_out)
            assert tN.gram_flops(s, p_in, p_out) == \
                jN.gram_flops(s, p_in, p_out)
            assert tN.direct_flops(s, p_in, p_out) == \
                jN.direct_flops(s, p_in, p_out)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("method", ["auto", "gram", "direct", "factorized"])
def test_stat_dense(method, use_kernels):
    h, z = _arrays((3, 10, 12), (3, 10, 7))
    want = jN.stat_dense(jnp.asarray(h), jnp.asarray(z), method=method)
    got = tN.stat_dense(torch.from_numpy(h), torch.from_numpy(z),
                        method=method, use_kernels=use_kernels)
    _close(got, want)


def test_stat_dense_unknown_method_raises():
    h, z = _arrays((2, 3, 4), (2, 3, 5))
    with pytest.raises(ValueError):
        tN.stat_dense(torch.from_numpy(h), torch.from_numpy(z), "nope")


# ---------------------------------------------------------------------------
# spec validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [("a", "a"), ("all", "other"),
                                    ("all", "x", "all")])
def test_spec_rejects_bad_groups_like_reference(groups):
    with pytest.raises(ValueError):
        jT.PexSpec(groups=groups)
    with pytest.raises(ValueError):
        tT.PexSpec(groups=groups)


def test_spec_group_index_matches_reference():
    for groups in (("all",), ("attn", "mlp", "other"), ("attn", "mlp")):
        js, ts = jT.PexSpec(groups=groups), tT.PexSpec(groups=groups)
        for g in (None, "attn", "mlp", "embed"):
            try:
                want = js.group_index(g)
            except ValueError:
                with pytest.raises(ValueError):
                    ts.group_index(g)
            else:
                assert ts.group_index(g) == want


# ---------------------------------------------------------------------------
# tapped ops: dh, dW and the accumulator cotangent vs the reference's bwd
# ---------------------------------------------------------------------------

GROUPS = ("attn", "mlp", "all")


def _port_op(op, x, p, zbar, acc_bar, *, x_grad=True, **kw):
    """Run one tapped op of the port and backprop (zbar, acc_bar) through
    it; returns the gradients of (x, p, acc)."""
    x = torch.from_numpy(x).requires_grad_(x_grad)
    p = torch.from_numpy(p).requires_grad_()
    acc = torch.zeros(acc_bar.shape, requires_grad=True)
    tap = tT.Tap(tT.PexSpec(groups=GROUPS), acc=acc)
    if op == "embedding":
        z = tap.embedding(p, x, group="mlp")
    else:
        z = getattr(tap, op)(x, p, group="mlp", **kw)
    inputs = [x, p, acc] if x_grad else [p, acc]
    gs = torch.autograd.grad([z, tap.carry()], inputs,
                             [torch.from_numpy(zbar),
                              torch.from_numpy(acc_bar)])
    return gs if x_grad else (None, *gs)


@pytest.mark.parametrize("method", ["auto", "gram", "direct"])
@pytest.mark.parametrize("hshape", [(3, 8), (3, 7, 8)])
def test_dense_bwd_matches_reference(hshape, method):
    h, w = _arrays(hshape, (8, 5))
    zbar, acc_bar = _arrays(hshape[:-1] + (5,), (3, len(GROUPS)), seed=5)
    layout = jT.ExampleLayout(len(GROUPS))
    dh, dw, dacc = jT._pex_dense_bwd(method, False, 1, layout,
                                     (jnp.asarray(h), jnp.asarray(w)),
                                     (jnp.asarray(zbar), jnp.asarray(acc_bar)))
    th, tw, tacc = _port_op("dense", h, w, zbar, acc_bar, method=method)
    _close(th, dh)
    _close(tw, dw)
    _close(tacc, dacc)


@pytest.mark.parametrize("xshape", [(3, 6), (3, 4, 6)])
def test_bias_bwd_matches_reference(xshape):
    x, b = _arrays(xshape, (6,))
    zbar, acc_bar = _arrays(xshape, (3, len(GROUPS)), seed=6)
    dx, db, dacc = jT._pex_bias_bwd(1, jT.ExampleLayout(len(GROUPS)), None,
                                    (jnp.asarray(zbar), jnp.asarray(acc_bar)))
    tx, tb, tacc = _port_op("bias_add", x, b, zbar, acc_bar)
    _close(tx, dx)
    _close(tb, db)
    _close(tacc, dacc)


@pytest.mark.parametrize("hshape", [(3, 6), (3, 4, 6)])
def test_scale_bwd_matches_reference(hshape):
    h, g = _arrays(hshape, (6,))
    zbar, acc_bar = _arrays(hshape, (3, len(GROUPS)), seed=7)
    dh, dg, dacc = jT._pex_scale_bwd(1, jT.ExampleLayout(len(GROUPS)),
                                     (jnp.asarray(h), jnp.asarray(g)),
                                     (jnp.asarray(zbar), jnp.asarray(acc_bar)))
    th, tg, tacc = _port_op("scale", h, g, zbar, acc_bar)
    _close(th, dh)
    _close(tg, dg)
    _close(tacc, dacc)


def test_embedding_bwd_matches_reference():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 5, (3, 9))
    (table,) = _arrays((5, 4))
    zbar, acc_bar = _arrays((3, 9, 4), (3, len(GROUPS)), seed=9)
    dtab, _, dacc = jT._pex_embed_bwd(
        1, jT.ExampleLayout(len(GROUPS)),
        (jnp.asarray(ids, jnp.int32), jnp.asarray(table)),
        (jnp.asarray(zbar), jnp.asarray(acc_bar)))
    _, ttab, tacc = _port_op("embedding", ids, table, zbar, acc_bar,
                             x_grad=False)
    _close(ttab, dtab)
    _close(tacc, dacc)


def test_inert_tap_is_the_plain_op():
    h, w = _arrays((2, 3, 4), (4, 5))
    h, w = torch.from_numpy(h), torch.from_numpy(w)
    for tap in (tT.NULL, tT.Tap(tT.PexSpec()), tT.Tap(tT.DISABLED,
                                                       acc=torch.zeros(2, 1))):
        assert not tap.live
        torch.testing.assert_close(tap.dense(h, w), h @ w)
        torch.testing.assert_close(tap.scale(h, h), h * h)


@pytest.mark.parametrize("norms,grads", [(True, False), (False, True),
                                         (True, True)])
def test_backward_mode(norms, grads):
    """The tap's mode decides what the backward forms: no dW in a
    norms-only backward, no stat in a gradient-only one."""
    h, w = _arrays((2, 3, 4), (4, 5))
    h = torch.from_numpy(h).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    acc = torch.zeros(2, 1, requires_grad=True)
    tap = tT.Tap(tT.PexSpec(), acc=acc)
    z = tap.dense(h, w)
    tap.set_mode(norms=norms, grads=grads)
    gh, gw, gacc = torch.autograd.grad(z.sum(), [h, w, acc],
                                       allow_unused=True)
    assert gh is not None
    assert (gw is not None) == grads
    assert (gacc is not None) == norms
