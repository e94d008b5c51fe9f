"""The port's paper §6 one-pass clipping against the JAX reference's.

On the inputs of ``tests/test_pex_correctness.py`` (the MLP form and the
weight-shared sequence form), the port's
``onepass_clipped_weight_grads[_seq]`` is held against the reference's
(loss_vec, per-example norms, clipped weight gradients) and against the
port's own naive per-example oracle (``torch.func``); the helpers
(``norms_from_taps``, ``token_clip_coefficients``, ``zero_taps``) against
theirs. The Z̄ rescale and the MLP-form sums go through
``kernels.ops.clip_scale`` and ``kernels.ops.rowsumsq`` (their plain
versions on the CPU), which the tests count.

Tolerances: those of the reference's tests — norms 1e-5 relative against
the naive oracle, clipped gradients 1e-4 (atol 1e-6); 1e-5 against the
reference itself (f32, summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as jclip
from repro_torch.core import clipping as tclip
from repro_torch.core import naive
from repro_torch.kernels import ops as tops

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _mlp_case():
    """``test_onepass_paper_s6``'s inputs and forward."""
    rng = np.random.default_rng(1)
    b, d, h, o = 5, 7, 9, 4
    params = {"w1": rng.normal(size=(d, h)).astype(np.float32) * 0.4,
              "w2": rng.normal(size=(h, o)).astype(np.float32) * 0.4}
    batch = {"x": rng.normal(size=(b, d)).astype(np.float32),
             "y": rng.normal(size=(b, o)).astype(np.float32)}
    shapes = {"w1": (b, h), "w2": (b, o)}

    def forward(lib, tanh):
        def f(p, tp, bt):
            hs = {"w1": bt["x"]}
            z1 = bt["x"] @ p["w1"] + tp["w1"]
            h1 = tanh(z1)
            hs["w2"] = h1
            z2 = h1 @ p["w2"] + tp["w2"]
            return lib.sum(lib.square(z2 - bt["y"]), -1), hs
        return f
    return params, batch, shapes, forward, 0.7


def _seq_case():
    """``test_onepass_s6_sequence_model``'s inputs and forward."""
    rng = np.random.default_rng(3)
    b, s, d, h = 4, 6, 8, 10
    params = {"w1": rng.normal(size=(d, h)).astype(np.float32) * .4,
              "w2": rng.normal(size=(h, d)).astype(np.float32) * .4}
    batch = {"x": rng.normal(size=(b, s, d)).astype(np.float32),
             "y": rng.normal(size=(b, s, d)).astype(np.float32)}
    shapes = {"w1": (b, s, h), "w2": (b, s, d)}

    def forward(lib, tanh):
        def f(p, tp, bt):
            hs = {"w1": bt["x"]}
            z1 = bt["x"] @ p["w1"] + tp["w1"]
            h1 = tanh(z1)
            hs["w2"] = h1
            z2 = h1 @ p["w2"] + tp["w2"]
            return lib.sum(lib.square(z2 - bt["y"]), (1, 2)), hs
        return f
    return params, batch, shapes, forward, 0.9


CASES = {"mlp": (_mlp_case, "onepass_clipped_weight_grads"),
         "seq": (_seq_case, "onepass_clipped_weight_grads_seq")}


def _count(monkeypatch, name):
    calls = []
    fn = getattr(tops, name)

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(tops, name, counted)
    return calls


@pytest.mark.parametrize("form", sorted(CASES))
def test_onepass_matches_reference_and_naive(form, monkeypatch):
    make, fn_name = CASES[form]
    params, batch, shapes, forward, clip = make()
    j_lv, j_sq, j_wbar = getattr(jclip, fn_name)(
        forward(jnp, jnp.tanh),
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, shapes, clip)

    scale_calls = _count(monkeypatch, "clip_scale")
    sumsq_calls = _count(monkeypatch, "rowsumsq")
    t_params = {k: torch.from_numpy(v) for k, v in params.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_fwd = forward(torch, torch.tanh)
    lv, sq, wbar = getattr(tclip, fn_name)(t_fwd, t_params, t_batch, shapes,
                                           clip)
    assert len(scale_calls) == len(shapes)        # one per tapped layer
    assert len(sumsq_calls) == (2 * len(shapes) if form == "mlp" else 0)
    _close(lv, j_lv)
    _close(sq, j_sq)
    for k in params:
        _close(wbar[k], j_wbar[k])

    def single(p, ex):
        b1 = {k: v[None] for k, v in ex.items()}
        tz = {k: torch.zeros((1,) + s[1:]) for k, s in shapes.items()}
        return t_fwd(p, tz, b1)[0][0]

    oracle = naive.per_example_sq_norms(single, t_params, t_batch)
    _close(sq, oracle)
    pg = naive.per_example_grads(single, t_params, t_batch)
    c = torch.clamp(clip / (torch.sqrt(oracle) + 1e-6), max=1.0)
    assert float(c.min()) < 1.0
    for k in params:
        want = torch.einsum("b,b...->...", c, pg[k])
        _close(wbar[k], want.numpy(), rtol=1e-4)


def test_norms_from_taps_folds_extra_axes():
    """The MLP-form norms on (B, S, p) taps fold the sequence axis, as the
    reference does (an upper bound, not the exact norm)."""
    rng = np.random.default_rng(5)
    hs = {"a": rng.normal(size=(3, 4, 6)).astype(np.float32),
          "b": rng.normal(size=(3, 5)).astype(np.float32)}
    zs = {"a": rng.normal(size=(3, 4, 2)).astype(np.float32),
          "b": rng.normal(size=(3, 7)).astype(np.float32)}
    want = jclip.norms_from_taps(
        {k: jnp.asarray(v) for k, v in hs.items()},
        {k: jnp.asarray(v) for k, v in zs.items()})
    got = tclip.norms_from_taps(
        {k: torch.from_numpy(v) for k, v in hs.items()},
        {k: torch.from_numpy(v) for k, v in zs.items()})
    _close(got, want)


def test_token_clip_coefficients_and_zero_taps():
    sq = np.random.default_rng(6).gamma(2.0, size=(3, 5)).astype(np.float32)
    sq[0, 0] = 0.0
    _close(tclip.token_clip_coefficients(torch.from_numpy(sq), 1.3),
           jclip.token_clip_coefficients(jnp.asarray(sq), 1.3))
    taps = tclip.zero_taps({"a": (2, 3), "b": (2, 4, 5)}, device="cpu")
    assert {k: tuple(v.shape) for k, v in taps.items()} == \
        {"a": (2, 3), "b": (2, 4, 5)}
    assert all(float(v.abs().sum()) == 0 and v.dtype == torch.float32
               for v in taps.values())
