"""The port's RWKV6 (``nn/rwkv.py``, ``models/rwkv6.py``) against the JAX
reference's.

Units on the same numpy inputs and the reference's ``init`` parameters
(their μ's, w0 and u drawn away from their zero/constant inits so that
every path binds), in f32 and bf16: ``_token_shift``, ``rwkv_tmix`` and
``rwkv_cmix`` — the output, and each tap's per-example stat as its own
norm column (the five ``mix_b`` slices apart) of ``Engine.step([Norms()])``
on L_j = Σ y_j ⊙ r_j (bf16 stats by ``close_stats_bf16``: the r and k
streams' taps feed the recurrence through long chains of bf16 cotangents,
and the reference's own stats there sit up to ~4% from the f32 ones). The
chunked WKV recurrence against the plain
per-step loop with ``CHUNK`` forced to 3 on S = 8: outputs bit for bit,
input gradients within 1e-6, and the same through ``Engine.step`` (two
backward passes on one graph) and the port's ``vmap(grad)`` oracle. The
rwkv6-3b smoke step against the reference's jitted ``Engine.step`` in
``[Norms, Grads]`` (per group), ``[Clip(1.0), Grads]`` and ``[Norms]``
with ``method="direct"`` forced; the declared untapped scope against the
reference's; interop, batches, the published config and the launcher.
Tolerances as in ``tests/torch_family_parity.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_parity as fp
from repro import pex as jpex
from repro.models import registry as jreg
from repro.nn import rwkv as jrwkv
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.core import naive
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry
from repro_torch.nn import rwkv as trwkv
from repro_torch.nn.param import tree_flatten, tree_map

ARCH = "rwkv6-3b"
B, S = 3, 12
TMIX_TAPS = ("mix_a", "mix_b0", "mix_b1", "mix_b2", "mix_b3", "mix_b4", "wr",
             "wk", "wv", "wg", "decay_a", "decay_b", "ln_x_g", "ln_x_b", "wo")
CMIX_TAPS = ("wk", "wv", "wr")
GROUPS = ("rwkv", "norm", "embed", "head")


@pytest.fixture(scope="module")
def st():
    return fp.setup(ARCH, B, S)


def test_published_config():
    full, jfull = registry.get(ARCH).full(), jreg.get(ARCH).full()
    for k in ("name", "n_layers", "d_model", "vocab", "d_ff", "dtype"):
        assert getattr(full, k) == getattr(jfull, k), k
    assert (full.n_layers, full.d_model, full.vocab, full.d_ff) \
        == (32, 2560, 65536, 8960)
    assert dataclasses.asdict(full.rwkv_cfg) \
        == dataclasses.asdict(jfull.rwkv_cfg)
    assert full.rwkv_cfg.n_heads == 40


def test_interop_round_trip_and_batch(st):
    fp.round_trip(st)
    assert len(st["params"]["blocks"]) == st["cfg"].n_layers


def test_bf16_dtypes_kept_by_init_adamw_and_noise():
    """In bf16, w0 and u stay f32 and every other leaf is bf16, in both
    packages' ``init``; one AdamW update and the in-place noise add keep
    every leaf's dtype."""
    fp.check_bf16_dtypes(ARCH, {"w0", "u"})


# --- units ---------------------------------------------------------------

def _unit_params(init, cfg, jdt, seed):
    """The reference's ``init`` with its μ's (and the time mix's w0 and u)
    redrawn, so that every term binds."""
    p = unbox(init(jax.random.PRNGKey(seed), cfg, dtype=jdt))
    rng = np.random.default_rng(seed)
    p["mu"] = jnp.asarray(rng.normal(size=p["mu"].shape) * 0.5, jdt)
    if "w0" in p:
        p["w0"] = jnp.asarray(rng.normal(-1.0, 0.5, p["w0"].shape),
                              jnp.float32)
        p["u"] = jnp.asarray(rng.normal(size=p["u"].shape) * 0.5,
                             jnp.float32)
    return p


@pytest.mark.parametrize("dt", fp.DTYPES)
def test_token_shift_matches(dt):
    rng = np.random.default_rng(0)
    jx, tx = fp.pair(rng, (2, 7, 16), dt)
    want = jrwkv._token_shift(jx, None)
    got = trwkv._token_shift(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


def _unit(dt, monkeypatch, jfn, tfn, init, taps, seed):
    jdt, tdt = fp.DTYPES[dt]
    jcfg = jreg.get(ARCH).smoke().rwkv_cfg
    cfg = registry.get(ARCH).smoke().rwkv_cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = _unit_params(init, jcfg, jdt, seed)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(seed + 10)
    jx, tx = fp.pair(rng, (B, S, jcfg.d_model), dt)
    jr, tr = fp.pair(rng, (B, S, jcfg.d_model), dt)

    want = jfn(jp, jx, tap=jpex.NULL, cfg=jcfg)[0]
    got = tfn(tp, tx, tap=pex.NULL, cfg=cfg)
    assert got.dtype == tdt
    fp.close_dt(got, want, dt)

    def jloss(p, b, tap):
        out = jfn(p, b["x"], tap=tap, cfg=jcfg)[0]
        return jnp.sum((out * b["r"]).astype(jnp.float32), axis=(1, 2)), {}

    def tloss(p, b, tap):
        out = tfn(p, b["x"], tap=tap, cfg=cfg)
        return torch.sum((out * b["r"]).float(), dim=(1, 2)), {}

    fp.per_call_groups(monkeypatch, taps)
    eng = jpex.Engine(jpex.PexSpec(groups=taps))
    want = jax.jit(lambda p, b: eng.step(jloss, p, b, [jpex.Norms()]))(
        jp, {"x": jx, "r": jr}).sq_norms
    got = pex.Engine(pex.PexSpec(groups=taps)).step(
        tloss, tp, {"x": tx, "r": tr}, [pex.Norms()]).sq_norms
    assert got.shape == (B, len(taps)) and bool((got > 0).all())
    if dt == "f32":
        fp.close(got, want, fp.RTOL)
        return
    # the f32 stats on the bf16-rounded parameters and inputs (the f32 case
    # holds the port's f32 against the reference's)
    p32 = tree_map(lambda x: x.float(), tp)
    truth = pex.Engine(pex.PexSpec(groups=taps)).step(
        tloss, p32, {"x": tx.float(), "r": tr.float()},
        [pex.Norms()]).sq_norms
    fp.close_stats_bf16(got, want, truth)


@pytest.mark.parametrize("dt", fp.DTYPES)
def test_tmix_and_tap_stats_match(dt, monkeypatch):
    """The time mix's output, and the stats of its 15 taps: mix_a, the five
    mix_b slices (each a strided view of tanh(mix_a)), r/k/v/g, the decay
    LoRA, ln_x's gain and bias, and wo."""
    _unit(dt, monkeypatch, jrwkv.rwkv_tmix, trwkv.rwkv_tmix,
          jrwkv.init_rwkv_tmix, TMIX_TAPS, 1)


@pytest.mark.parametrize("dt", fp.DTYPES)
def test_cmix_and_tap_stats_match(dt, monkeypatch):
    _unit(dt, monkeypatch, jrwkv.rwkv_cmix, trwkv.rwkv_cmix,
          jrwkv.init_rwkv_cmix, CMIX_TAPS, 2)


def test_decode_state_raises():
    """A decode state without its buffers raises; one from
    ``init_rwkv_state`` is written in place (the decode itself is held
    against the reference in ``tests/test_torch_serve_cache.py``)."""
    cfg = registry.get(ARCH).smoke().rwkv_cfg
    p = trwkv.init_rwkv_cmix(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32, device="cpu")
    x = torch.ones(1, 2, cfg.d_model)
    with pytest.raises(KeyError, match="cm_shift"):
        trwkv.rwkv_cmix(p, x, tap=pex.NULL, cfg=cfg, state={})
    state = trwkv.init_rwkv_state(1, cfg, dtype=torch.float32, device="cpu")
    trwkv.rwkv_cmix(p, x, tap=pex.NULL, cfg=cfg, state=state)
    assert torch.equal(state["cm_shift"], x[:, -1])


# --- the chunked recurrence ---------------------------------------------

def _wkv_inputs(seed=4):
    rng = np.random.default_rng(seed)
    b, s, nh, hd = 2, 8, 3, 4
    r, k, v = (torch.from_numpy(rng.normal(size=(b, s, nh, hd))).float()
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (b, s, nh, hd))).float()
    u = torch.from_numpy(rng.normal(size=(nh, hd))).float()
    return [r, k, v, w, u]


def test_wkv_chunks_match_the_plain_loop(monkeypatch):
    """CHUNK = 3 on S = 8 (chunks of 3, 3 and 2 steps): the forward gives
    the plain loop's bits, the hand-written backward its input gradients
    within 1e-6 (in f64 within 1e-12), and a second backward over the
    retained graph the same gradients again."""
    monkeypatch.setattr(trwkv, "CHUNK", 3)
    ins = [x.requires_grad_() for x in _wkv_inputs()]
    plain, chunked = trwkv.wkv_loop(*ins), trwkv.wkv(*ins)
    assert torch.equal(plain, chunked)
    do = torch.from_numpy(np.random.default_rng(5).normal(
        size=plain.shape)).float()
    want = torch.autograd.grad(plain, ins, do)
    got = torch.autograd.grad(chunked, ins, do, retain_graph=True)
    again = torch.autograd.grad(chunked, ins, do)
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        assert torch.equal(g, a)
    # in f64 the hand-written backward is autograd's to rounding: what
    # separates the two in f32 is the order of the sums, not the algebra
    ins64 = [x.detach().double().requires_grad_() for x in ins]
    want64 = torch.autograd.grad(trwkv.wkv_loop(*ins64), ins64, do.double())
    got64 = torch.autograd.grad(trwkv.wkv(*ins64), ins64, do.double())
    for g, w in zip(got64, want64):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def _plain_recurrence(monkeypatch):
    monkeypatch.setattr(trwkv, "wkv", trwkv.wkv_loop)


def test_wkv_chunks_through_engine_step(monkeypatch):
    """The smoke model at S = 8 with CHUNK = 3 through ``Engine.step([Norms,
    Clip(1.0)])`` (a norms backward and a reweighted backward on one graph)
    against the same step on the plain per-step loop: the losses bit for
    bit, the norms within 1e-6, the clipped gradients within 1e-5 of each
    leaf's largest |value| (f32 rounding of the hand-written backward,
    carried through the model's other layers)."""
    st = fp.setup(ARCH, B, 8)
    monkeypatch.setattr(trwkv, "CHUNK", 3)
    cons = [pex.Norms(), pex.Clip(1.0)]
    got = pex.Engine(pex.PexSpec()).step(st["loss"], st["params"],
                                         st["batch"], cons)
    _plain_recurrence(monkeypatch)
    want = pex.Engine(pex.PexSpec()).step(st["loss"], st["params"],
                                          st["batch"], cons)
    assert torch.equal(got.loss_vec, want.loss_vec)
    torch.testing.assert_close(got.sq_norms, want.sq_norms, rtol=1e-6,
                               atol=0)
    for g, w in zip(tree_flatten(got.grads)[0], tree_flatten(want.grads)[0]):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


def test_wkv_chunks_under_the_vmap_grad_oracle(monkeypatch):
    """The port's naive oracle (``vmap(grad)``) runs the chunked
    recurrence through its generated vmap rule: per-example gradients
    within 1e-5 of each leaf's largest |value| of those through the plain
    loop."""
    st = fp.setup(ARCH, B, 8)
    monkeypatch.setattr(trwkv, "CHUNK", 3)
    loss = st["loss"]

    def single(p, ex):
        return loss(p, {k: v[None] for k, v in ex.items()}, pex.NULL)[0][0]

    got = naive.per_example_grads(single, st["params"], st["batch"])
    _plain_recurrence(monkeypatch)
    want = naive.per_example_grads(single, st["params"], st["batch"])
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


# --- the smoke step -------------------------------------------------------

def test_step_norms_and_grads_match(st):
    """[Norms, Grads] with one norm column per group (the time and channel
    mixes' matrices, the layernorms, the embedding and the head)."""
    t, j = fp.steps(st, [pex.Norms(), pex.Grads()],
                    [jpex.Norms(), jpex.Grads()], groups=GROUPS)
    assert t.sq_norms.shape == (B, len(GROUPS))
    assert bool((t.sq_norms > 0).all())
    fp.close(t.loss_vec, j.loss_vec)
    fp.close(t.sq_norms, j.sq_norms)
    fp.close_trees(t.grads, j.grads)


def test_step_clip_matches(st):
    t, j = fp.steps(st, [pex.Clip(1.0), pex.Grads()],
                    [jpex.Clip(1.0), jpex.Grads()])
    fp.close(t.sq_norms, j.sq_norms)
    fp.close(t.clip_coef, j.clip_coef)
    assert float(t.clip_coef.max()) < 1.0
    fp.close_trees(t.grads, j.grads)


def test_step_direct_method_matches(st):
    """``method="direct"`` forced, as ``tests/test_archs_exact.py`` does
    for rwkv6: the thin LoRA taps and the rest on the direct form."""
    t, j = fp.steps(st, [pex.Norms()], [jpex.Norms()], method="direct")
    fp.close(t.sq_norms, j.sq_norms)


def test_scope_matches_reference(st):
    """mu (both mixes), w0 and u: the four stacked leaves the reference's
    scope filter drops, and the port's norms equal its own oracle over the
    rest."""
    assert fp.scope_matches_reference(st) == 4
    fp.norms_match_own_oracle(st)


def test_launcher_trains_rwkv6(capsys):
    ms = tlaunch.main(["--arch", ARCH, "--smoke", "--mode", "clip",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--device", "cpu"])
    assert len(ms) == 1 and np.isfinite(ms[0]["loss"])
    assert "[1] loss=" in capsys.readouterr().out
