"""The port's flash attention against the JAX reference's, on the CPU.

Kernel level: the same numpy inputs go through the reference's Pallas
kernels (``interpret=True``, as ``tests/test_kernels.py`` runs them) and
through the port's wrappers in ``repro_torch.kernels.ops``, which take the
plain PyTorch versions for CPU tensors: (O, lse), (dQ, dK, dV), the autograd
gradients of ``flash_attention_vjp`` against ``jax.vjp`` of the reference's,
and the two ``flash_attention_ref`` oracles. Tolerance: f32 on both sides,
1e-5 of each output's max |value| (summation order of the einsums against
the blocked online softmax).

Slice level: the llama3.2-1b smoke config with ``AttnCfg.flash=True`` at
B=2, S=128 (the reference's own flash wiring test's shape): port
``Engine.step`` against the reference's, both with flash, at the slice's
1e-4 (as in ``tests/test_torch_llama_step.py``); the port's flash route
against its unfused route; and the route itself, counted through
``ops.flash_attention`` (S % 128 == 0 takes it, S=12 does not, as in the
reference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention import flash_attention_bwd as jfa_bwd
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import passes
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import registry
from repro_torch.nn.param import tree_flatten

KTOL = 1e-5          # kernel level, of max |value|
RTOL = 1e-4          # slice level
ARCH = "llama3.2-1b"

# (B, Hq, Hkv, S, D, softcap, window); S a multiple of 128 for Pallas
CASES = {
    "gqa": (2, 4, 2, 256, 32, None, None),
    "mha": (1, 2, 2, 128, 64, None, None),
    "softcap": (2, 4, 1, 128, 32, 30.0, None),
    "window": (1, 2, 2, 256, 32, None, 128),
}
RAGGED = {
    "ragged": (2, 4, 2, 200, 32, None, None),
    "ragged_cap_window": (1, 2, 1, 77, 16, 20.0, 30),
}


def _inputs(case, seed):
    b, hq, hkv, s, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]


def _kw(case):
    return dict(scale=case[4] ** -0.5, softcap=case[5], window=case[6])


def _close(got, want, tol=KTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_pallas(name):
    case = CASES[name]
    q, k, v, _ = _inputs(case, 0)
    o, lse = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  return_lse=True, **_kw(case))
    jo, jlse = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   block_q=128, block_k=128, interpret=True,
                   return_lse=True, **_kw(case))
    _close(o, jo)
    _close(lse, jlse)
    _close(o, jref.flash_attention_ref(q, k, v, **_kw(case)))


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_forward_ragged_matches_ref(name):
    """S that no 128-block divides: the reference's Pallas kernel refuses
    it, its plain oracle does not."""
    case = RAGGED[name]
    q, k, v, _ = _inputs(case, 1)
    o = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), **_kw(case))
    _close(o, jref.flash_attention_ref(q, k, v, **_kw(case)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_pallas(name):
    """dQ, dK, dV from the same O, lse and dO: the reference's Pallas dq
    and dkv kernels against the port's plain backward."""
    case = CASES[name]
    q, k, v, do = _inputs(case, 2)
    kw = _kw(case)
    jo, jlse = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   block_q=128, block_k=128, interpret=True,
                   return_lse=True, **kw)
    want = jfa_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse,
                   jnp.asarray(do), block_q=128, block_k=128,
                   interpret=True, **kw)
    got = tops.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(jo), np.array(jlse),
                                do)), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window", [None, 128])
def test_vjp_matches_jax(window):
    """Gradients through ``torch.autograd`` of the port's
    ``flash_attention_vjp`` against ``jax.vjp`` of the reference's."""
    case = (2, 4, 2, 256, 32, None, window)
    q, k, v, do = _inputs(case, 3)
    scale = case[4] ** -0.5
    jo, vjp = jax.vjp(lambda a, b, c: jops.flash_attention_vjp(
        a, b, c, scale, window), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tops.flash_attention_vjp(tq, tk, tv, scale, window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _close(o, jo)
    for g, w in zip(got, want):
        _close(g, w)
    # only the inputs that ask for a gradient get one
    o = tops.flash_attention_vjp(tq.detach(), tk.detach(), tv, scale, window)
    (gv,) = torch.autograd.grad(o, (tv,), torch.from_numpy(do))
    _close(gv, want[2])


@pytest.mark.parametrize("name", sorted(CASES) + sorted(RAGGED))
def test_ref_matches_jax_ref(name):
    case = {**CASES, **RAGGED}[name]
    q, k, v, _ = _inputs(case, 4)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   **_kw(case))
    _close(got, jref.flash_attention_ref(q, k, v, **_kw(case)))


@pytest.mark.parametrize("sq,sk,window", [(512, 512, None), (200, 200, None),
                                          (256, 256, 128), (77, 77, 30),
                                          (64, 100, None), (100, 64, 7)])
def test_work_estimates_count_the_causal_pairs(sq, sk, window):
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    pairs = int(mask.sum())
    assert tfa.causal_pairs(sq, sk, window) == pairs
    for kind, n in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        assert tfa.flop_estimate(kind, 2, 4, sq, sk, 64, window) == \
            2 * n * 2 * 4 * pairs * 64


def test_work_estimates_at_the_main_shape():
    """llama3.2-1b at B=8, S=512, bf16: 131,328 causal pairs per head."""
    assert tfa.causal_pairs(512, 512) == 131_328
    assert tfa.flop_estimate("fwd", 8, 32, 512, 512, 64) == 8_606_711_808
    q = 8 * 32 * 512 * 64 * 2
    kv = 8 * 8 * 512 * 64 * 2
    rows = 8 * 32 * 512 * 4
    assert tfa.byte_estimate("fwd", 8, 32, 8, 512, 512, 64, 2) == \
        2 * q + 2 * kv + rows
    assert tfa.byte_estimate("dq", 8, 32, 8, 512, 512, 64, 2) == \
        3 * q + 2 * kv + 2 * rows
    assert tfa.byte_estimate("dkv", 8, 32, 8, 512, 512, 64, 2) == \
        2 * q + 4 * kv + 2 * rows


def test_launchers_take_only_cuda_tensors():
    """No fallback: the kernel launchers refuse CPU tensors, and the
    wrappers refuse inputs split across devices."""
    q, k, v, do = map(torch.from_numpy, _inputs(CASES["mha"], 5))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v, scale=0.1)
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(q, k, v, do, lse, lse, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(q, k, v, do, lse, lse, scale=0.1)
    with pytest.raises(ValueError, match="CPU or on a CUDA"):
        tops.flash_attention(q, k.to("meta"), v, scale=0.1)


# ---------------------------------------------------------------------------
# the bf16 kernels' schedule and copy route, as the launchers pass them
# ---------------------------------------------------------------------------

def _work_tiles(row):
    """The distinct (key tile, first q tile, end q tile) of a dK/dV block's
    row of ``dkv_work``."""
    return [row[:3]] if row[0] == row[3] else [row[:3], row[3:]]


@pytest.mark.parametrize("sk", [1, 63, 64, 65, 200, 320, 333, 448, 512,
                                4097])
def test_dkv_pairs_cover_every_key_tile_once(sk):
    """Each (batch, kv head)'s 64-key tiles, ragged last tile included, go
    to exactly one dK/dV block of the launcher's table: one writer per
    output tile."""
    n = -(-sk // tfa.KEY_TILE)
    rows = tfa.dkv_work(sk, sk)
    assert len(rows) == (n + 1) // 2
    owned = [t[0] for row in rows for t in _work_tiles(row)]
    assert sorted(owned) == list(range(n))
    assert all(len(_work_tiles(row)) == 2 for row in rows[:n // 2])


@pytest.mark.parametrize("s,rep", [(512, 4), (320, 8), (448, 1), (65, 2),
                                   (333, 4)])
def test_dkv_pairs_balance_the_causal_walk(s, rep):
    """Under the causal mask every pair meets n + 1 q tiles per q head (the
    middle tile of an odd n, alone, meets (n + 1) / 2): the blocks of a
    launch walk the same number of steps."""
    n = -(-s // tfa.KEY_TILE)
    steps = []
    for row in tfa.dkv_work(s, s):
        tiles = _work_tiles(row)
        steps.append(rep * sum(max(hi - lo, 0) for _, lo, hi in tiles))
        assert steps[-1] == rep * (n + 1 if len(tiles) == 2
                                   else (n + 1) // 2)
    assert sum(steps) == rep * n * (n + 1) // 2


@pytest.mark.parametrize("sq,sk,window", [(512, 512, None), (333, 333, 100),
                                          (256, 256, 48), (65, 65, None),
                                          (64, 100, None), (100, 64, 7)])
def test_query_tiles_hold_every_visible_query(sq, sk, window):
    """The q tiles the dK/dV table gives a key tile are those holding a
    query that sees one of its keys, at ragged S and with a window."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    t = tfa.KEY_TILE
    walked = {}
    for row in tfa.dkv_work(sq, sk, window):
        for tile, lo, hi in _work_tiles(row):
            walked[tile] = set(range(lo, hi))
    assert sorted(walked) == list(range(-(-sk // t)))
    for tile, got in walked.items():
        k0 = tile * t
        seen = np.flatnonzero(mask[:, k0:k0 + t].any(axis=1)) // t
        want = set(seen.tolist())
        assert want <= got
        # no tile walked in vain, but those a window's end rounds into
        assert len(got - want) <= (0 if window is None else 1)


def test_copy_route_follows_the_strides():
    """16-byte strides and bases (the model's (B, S, H, D) views, q, k and
    v sliced from a fused projection) take TMA; rows of an odd pitch or an
    offset base are staged synchronously."""
    bf = torch.bfloat16
    x = torch.zeros(2, 16, 6, 64, dtype=bf)
    q, k, v = x.split((4, 1, 1), dim=2)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert tfa.copy_route(*views) == "tma"
    odd = torch.zeros(2, 16, 4, 65, dtype=bf)[..., :64].transpose(1, 2)
    assert tfa.copy_route(views[0], odd) == "synchronous"
    shifted = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=bf)[1:].view(
        2, 4, 16, 64)
    assert tfa.copy_route(shifted) == "synchronous"
    assert tfa.copy_route(torch.zeros(2, 4, 16, 64, dtype=bf)) == "tma"


# ---------------------------------------------------------------------------
# the slice: llama3.2-1b smoke, flash=True, B=2, S=128
# ---------------------------------------------------------------------------

B, S = 2, 128


def _flash(cfg):
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             flash=True))


@pytest.fixture(scope="module")
def setup():
    jspec = jreg.get(ARCH)
    jcfg = _flash(jspec.smoke())
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    spec = registry.get(ARCH)
    cfg = _flash(spec.smoke())
    params = interop.params_from_numpy(np_params, device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", S, B),
                                      3, device="cpu")
    return dict(jloss=jreg.make_loss_fn_v2(jspec, jcfg), jparams=jparams,
                jbatch=jbatch, spec=spec, cfg=cfg, params=params,
                batch=batch, loss=registry.make_loss_fn_v2(spec, cfg))


def _jax_step(st, consumers):
    return jpex.Engine(jpex.PexSpec()).step(st["jloss"], st["jparams"],
                                            st["jbatch"], consumers)


def _port_step(st, consumers, loss=None, batch=None):
    return pex.Engine(pex.PexSpec()).step(loss or st["loss"], st["params"],
                                          batch or st["batch"], consumers)


def _close_trees(port_tree, jax_tree, rtol=RTOL):
    """Leafwise, to ``rtol`` of the leaf's largest element."""
    got = jax.tree_util.tree_leaves_with_path(
        interop.params_to_numpy(port_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


def _rel(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=1e-6)


def test_flash_step_norms_and_grads_match(setup):
    j = _jax_step(setup, [jpex.Norms(), jpex.Grads()])
    t = _port_step(setup, [pex.Norms(), pex.Grads()])
    _rel(t.loss_vec, j.loss_vec)
    _rel(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)


def test_flash_step_clip_noise_gns_with_injected_sample(setup, monkeypatch):
    """Both packages add the same N(0, 1) sample: the reference's own draw
    (noised − clean grads) is handed to the port."""
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
    _rel(t.clip_coef, noisy.clip_coef)
    _rel(t.gns, noisy.gns)
    _close_trees(t.grads, noisy.grads)


def _count_calls(monkeypatch):
    calls = {"flash_attention": 0, "flash_attention_bwd": 0}

    def counted(name):
        fn = getattr(tops, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tops, name, counted(name))
    return calls


def test_flash_route_matches_unfused_route(setup, monkeypatch):
    """Same parameters and batch, flash and unfused: the same loss, norms
    and gradients; the flash step goes through ``ops.flash_attention``
    once per layer in the forward and once more in its one fused
    backward's recompute of each checkpointed block (remat, on by
    default), and through ``ops.flash_attention_bwd`` once per layer."""
    calls = _count_calls(monkeypatch)
    t = _port_step(setup, [pex.Norms(), pex.Grads()])
    n = setup["cfg"].n_layers
    assert setup["cfg"].remat
    assert calls == {"flash_attention": n * (1 + 1),
                     "flash_attention_bwd": n}
    unfused_cfg = setup["spec"].smoke()
    assert not unfused_cfg.attn.flash
    u = _port_step(setup, [pex.Norms(), pex.Grads()],
                   loss=registry.make_loss_fn_v2(setup["spec"], unfused_cfg))
    assert calls == {"flash_attention": n * (1 + 1),
                     "flash_attention_bwd": n}
    _rel(t.loss_vec, u.loss_vec.numpy())
    _rel(t.sq_norms, u.sq_norms.numpy())
    for g, w in zip(tree_flatten(t.grads)[0], tree_flatten(u.grads)[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=RTOL * float(w.abs().max()))


def test_flash_route_takes_the_reference_gate(setup, monkeypatch):
    """S=12 is no multiple of 128: with flash=True the step runs the
    unfused core, as the reference's gate does, and matches it."""
    calls = _count_calls(monkeypatch)
    batch = registry.make_train_batch(setup["spec"], setup["cfg"],
                                      ShapeSpec("t", "train", 12, B), 3,
                                      device="cpu")
    t = _port_step(setup, [pex.Norms(), pex.Clip(1.0)], batch=batch)
    assert calls == {"flash_attention": 0, "flash_attention_bwd": 0}
    jbatch = jreg.make_train_batch(jreg.get(ARCH), _flash(jreg.get(ARCH)
                                                          .smoke()),
                                   JShape("t", "train", 12, B), 3)
    j = jpex.Engine(jpex.PexSpec()).step(setup["jloss"], setup["jparams"],
                                         jbatch, [jpex.Norms(),
                                                  jpex.Clip(1.0)])
    _rel(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)
