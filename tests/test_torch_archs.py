"""The port's other dense GQA configs against the JAX reference's.

qwen2-7b (QKV bias, head padding 7 → 8), minitron-4b (squared ReLU, no
gate, head padding 3 → 4), gemma2-9b ((1+g) RMSNorm gains, sandwich norms,
alternating local/global layers, attention and final logit softcaps,
embeds × √d, query scale 16^-1/2) and qwen2-vl-7b (M-RoPE, merged visual
embeds), each at its smoke config: the reference's ``init`` parameters
are carried into the port by ``repro_torch.interop``, the batch comes from
the same numpy seed (qwen2-vl's with its visual inputs), and
``Engine.step`` of both packages is compared: loss_vec, grads, per-example
per-group norms and clip coefficients at 1e-4 (f32, as in
``tests/test_torch_llama_step.py``). gemma2 runs at S=24, past its smoke
window of 8; qwen2-vl runs once more on three distinct t/h/w position
streams, on which the M-RoPE sections matter, and once on the text-only
fallback. The port's norms are also held against its own naive oracle.

The features are also held one by one, in f32 and in bf16: ``rmsnorm``
with ``plus_one`` ((1+g) formed in f32, then rounded), ``layernorm``,
``mrope_angles`` and M-RoPE applied to bf16 heads, ``_attend`` with the
softcap (on the f32 logits), the window and ``local_flag``, the embed's
× √d (the constant rounded to the embed's dtype first: exactly equal),
the head's softcap (in the logits' dtype) and ``load_balance_loss``.
bf16 tolerance: 1e-2 of the largest |value| — the outputs round to bf16
(2^-8 relative) and the two packages' f32 transcendentals (rsqrt, tanh,
exp) may put a value on either side of a rounding step. That tolerance
cannot tell where a value rounds, so each bf16 rounding point is also
held on inputs that expose it, beside a variant that rounds elsewhere and
must fail: √d and (1+g) bit for bit, the head's softcap within one bf16
step, the attention softcap within 2^-8 of the largest |value|.

The flash gate: with ``AttnCfg.flash`` gemma2 takes the unfused route
(softcap and local flags), counted through ``ops.flash_attention_vjp``,
as the reference's gate does; qwen2-vl takes the flash route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn import attention as jattn
from repro.nn import embedding as jemb
from repro.nn import moe as jmoe
from repro.nn import norms as jnorms
from repro.nn import rotary as jrot
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import naive
from repro_torch.kernels import ops as tops
from repro_torch.models import registry
from repro_torch.nn import attention as tattn
from repro_torch.nn import embedding as temb
from repro_torch.nn import moe as tmoe
from repro_torch.nn import norms as tnorms
from repro_torch.nn import rotary as trot

RTOL = 1e-4
ATOL = 1e-6
BF16_TOL = 1e-2
B, S = 3, 24
ARCHS = ("qwen2-7b", "minitron-4b", "gemma2-9b", "qwen2-vl-7b")
GROUPS = ("attn", "mlp", "norm", "embed", "head")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _setup(arch, jcfg=None, cfg=None, s=S, b=B):
    jspec = jreg.get(arch)
    jcfg = jcfg or jspec.smoke()
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", s, b), 3)
    spec = registry.get(arch)
    cfg = cfg or spec.smoke()
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", s, b),
                                      3, device="cpu")
    return dict(arch=arch, jloss=jreg.make_loss_fn_v2(jspec, jcfg),
                jparams=jparams,
                jbatch=jbatch, np_params=np_params, cfg=cfg,
                params=interop.params_from_numpy(np_params, device="cpu"),
                batch=batch, loss=registry.make_loss_fn_v2(spec, cfg))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _jax_step(st, consumers, groups=("all",), batch=None):
    eng = jpex.Engine(jpex.PexSpec(groups=groups))
    return eng.step(st["jloss"], st["jparams"],
                    st["jbatch"] if batch is None else batch, consumers)


def _port_step(st, consumers, groups=("all",), batch=None):
    eng = pex.Engine(pex.PexSpec(groups=groups))
    return eng.step(st["loss"], st["params"],
                    st["batch"] if batch is None else batch, consumers)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _close_max(got, want, tol):
    """Elementwise within ``tol`` of the largest |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _close_trees(port_tree, jax_tree, rtol=RTOL):
    """Leafwise, to ``rtol`` of the leaf's largest element."""
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


# --- the four archs' steps against the reference's ---------------------------

def test_registry_has_the_transformer_archs():
    assert set(ARCHS) | {"llama3.2-1b", "phi3.5-moe", "deepseek-v2-236b",
                         "rwkv6-3b", "zamba2-7b", "seamless-m4t-medium"} \
        == set(registry.ARCHS) == set(jreg.ARCHS)
    for arch in ARCHS:
        jfull, full = jreg.get(arch).full(), registry.get(arch).full()
        for k in ("n_layers", "d_model", "vocab", "rms_plus_one",
                  "post_norms", "alt_local_global", "logit_softcap",
                  "scale_embeds", "vl_inputs", "dtype"):
            assert getattr(full, k) == getattr(jfull, k), (arch, k)
        for k in ("n_heads", "n_kv", "head_dim", "bias", "softcap", "window",
                  "rope_theta", "rope_dim", "mrope_sections", "attn_scale",
                  "n_heads_p", "scale"):
            assert getattr(full.attn, k) == getattr(jfull.attn, k), (arch, k)
        assert dataclasses.asdict(full.mlp) == dataclasses.asdict(jfull.mlp)


def test_batch_and_params_carry_over(setup):
    """Same seed, same batch (qwen2-vl's visual inputs included); the
    reference's parameters carry over both ways, the new keys with them
    (sandwich norms, zero (1+g) gains, padded Q heads), and the port's own
    ``init`` gives the reference's tree of shapes with the same zeros."""
    for k, v in setup["jbatch"].items():
        got = setup["batch"][k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    assert sorted(setup["batch"]) == sorted(setup["jbatch"])
    back = interop.params_to_numpy(setup["params"])
    flat = jax.tree_util.tree_leaves_with_path(setup["np_params"])
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, want)
    cfg = setup["cfg"]
    assert len(setup["params"]["blocks"]) == cfg.n_layers
    own = registry.family_module(registry.get(setup["arch"])).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(np.shape, interop.params_to_numpy(own)) \
        == jax.tree_util.tree_map(np.shape, setup["np_params"])
    a = cfg.attn
    hreal = a.n_heads * a.head_dim
    for p in (own, setup["params"]):
        for blk in p["blocks"]:
            assert not blk["attn"]["wq"]["w"][:, hreal:].any()
            assert not blk["attn"]["wo"]["w"][hreal:].any()
            if cfg.post_norms:
                assert {"ln_attn_post", "ln_mlp_post"} <= set(blk)
            want_g = 0.0 if cfg.rms_plus_one else 1.0
            for k in ("ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post"):
                if k in blk:
                    assert bool((blk[k]["g"] == want_g).all()), k


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


def test_clip_matches(setup):
    j = _jax_step(setup, [jpex.Norms(), jpex.Clip(1.0)])
    t = _port_step(setup, [pex.Norms(), pex.Clip(1.0)])
    _close(t.sq_norms, j.sq_norms)
    _close(t.clip_coef, j.clip_coef)
    _close(t.weights, j.weights)
    _close_trees(t.grads, j.grads)


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


def _vl_positions_batches(st):
    """qwen2-vl's batch with three distinct t/h/w streams, from numpy."""
    rng = np.random.default_rng(11)
    t = np.broadcast_to(np.arange(S), (B, S))
    pos = np.stack([t, rng.integers(0, 6, (B, S)),
                    rng.integers(0, 9, (B, S))], axis=1)
    assert not (pos[:, 0] == pos[:, 1]).all()
    jb = dict(st["jbatch"], positions=jnp.asarray(pos, jnp.int32))
    tb = dict(st["batch"], positions=torch.as_tensor(pos, dtype=torch.long))
    return jb, tb


def test_qwen2_vl_distinct_position_streams_match():
    """On three distinct t/h/w streams each M-RoPE section rotates by its
    own stream: the step matches the reference's and differs from the
    text-only streams' step."""
    st = _setup("qwen2-vl-7b")
    jb, tb = _vl_positions_batches(st)
    j = _jax_step(st, [jpex.Norms(), jpex.Grads()], GROUPS, batch=jb)
    t = _port_step(st, [pex.Norms(), pex.Grads()], GROUPS, batch=tb)
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)
    text = _port_step(st, [pex.Norms()], GROUPS)
    assert float((text.loss_vec - t.loss_vec).abs().max()) > 1e-3


def test_qwen2_vl_text_only_fallback_matches():
    """Without visual inputs or positions (what ``SyntheticLM`` gives),
    both packages broadcast the arange to all three M-RoPE streams."""
    st = _setup("qwen2-vl-7b")
    keep = ("ids", "labels")
    jb = {k: st["jbatch"][k] for k in keep}
    tb = {k: st["batch"][k] for k in keep}
    j = _jax_step(st, [jpex.Norms(), jpex.Clip(1.0)], GROUPS, batch=jb)
    t = _port_step(st, [pex.Norms(), pex.Clip(1.0)], GROUPS, batch=tb)
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)


def test_gemma2_window_binds_at_this_length():
    """At S=24 the smoke window of 8 cuts the local layers' keys: the
    same model with the window off gives another loss."""
    st = _setup("gemma2-9b")
    cfg = st["cfg"]
    wide = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             window=None))
    got, _ = st["loss"](st["params"], st["batch"], pex.NULL)
    off, _ = registry.make_loss_fn_v2(registry.get("gemma2-9b"), wide)(
        st["params"], st["batch"], pex.NULL)
    assert float((got - off).abs().max()) > 1e-3


# --- the flash gate -----------------------------------------------------------

def _with_flash(cfg):
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             flash=True))


@pytest.mark.parametrize("arch, want", [("gemma2-9b", 0),
                                        ("qwen2-vl-7b", 2)])
def test_flash_gate(arch, want, monkeypatch):
    """With ``AttnCfg.flash`` at S=128: gemma2 (softcap, a local flag on
    every layer) takes the unfused route, as the reference's gate does;
    qwen2-vl takes the flash route, once per layer in the forward and once
    more in the one backward's recompute of each checkpointed block. Both
    steps match the reference's, which also runs with ``flash=True``."""
    jspec = jreg.get(arch)
    jcfg = _with_flash(jspec.smoke())
    st = _setup(arch, jcfg=jcfg, cfg=_with_flash(registry.get(arch).smoke()),
                s=128, b=2)
    calls = []
    vjp = tops.flash_attention_vjp

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return vjp(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention_vjp", counted)
    t = _port_step(st, [pex.Norms(), pex.Grads()])
    assert st["cfg"].remat
    assert len(calls) == want * (1 + 1)     # the forward, the recompute
    j = _jax_step(st, [jpex.Norms(), jpex.Grads()])
    _close(t.loss_vec, j.loss_vec)
    _close(t.sq_norms, j.sq_norms)
    _close_trees(t.grads, j.grads)


# --- the features one by one, f32 and bf16 -------------------------------------

def _pair(rng, shape, dt, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _tol(dt):
    return 1e-5 if dt == "f32" else BF16_TOL


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches(dt, plus_one):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 64), dt, 3.0)
    jg, tg = _pair(rng, (64,), dt, 0.5)
    want = jnorms.rmsnorm({"g": jg}, jx, tap=jpex.NULL, plus_one=plus_one)
    got = tnorms.rmsnorm({"g": tg}, tx, tap=pex.NULL, plus_one=plus_one)
    assert got.dtype == tx.dtype
    _close_max(got, want, _tol(dt))
    init = tnorms.init_rmsnorm(64, dtype=torch.float32, device="cpu",
                               plus_one=plus_one)
    assert float(init["g"].sum()) == (0.0 if plus_one else 64.0)


@pytest.mark.parametrize("dt", DTYPES)
def test_layernorm_matches(dt):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 5, 48), dt, 2.0)
    jg, tg = _pair(rng, (48,), dt)
    jb, tb = _pair(rng, (48,), dt)
    want = jnorms.layernorm({"g": jg, "b": jb}, jx + 1.5, tap=jpex.NULL)
    got = tnorms.layernorm({"g": tg, "b": tb}, tx + 1.5, tap=pex.NULL)
    _close_max(got, want, _tol(dt))
    init = tnorms.init_layernorm(48, dtype=torch.float32, device="cpu")
    assert bool((init["g"] == 1).all()) and not init["b"].any()


def test_layernorm_stats_match():
    """The tapped layernorm's per-example norms of g and b through the
    engine, against the reference's."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    y = rng.normal(size=(3, 7, 16)).astype(np.float32)
    p = {"g": rng.normal(size=(16,)).astype(np.float32),
         "b": rng.normal(size=(16,)).astype(np.float32)}

    def jloss(params, batch, tap):
        out = jnorms.layernorm(params, batch["x"], tap=tap)
        return jnp.sum((out - batch["y"]) ** 2, axis=(1, 2)), {}

    def tloss(params, batch, tap):
        out = tnorms.layernorm(params, batch["x"], tap=tap)
        return torch.sum((out - batch["y"]) ** 2, dim=(1, 2)), {}

    j = jpex.Engine(jpex.PexSpec()).step(
        jloss, {k: jnp.asarray(v) for k, v in p.items()},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        [jpex.Norms(), jpex.Grads()])
    t = pex.Engine(pex.PexSpec()).step(
        tloss, {k: torch.from_numpy(v) for k, v in p.items()},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        [pex.Norms(), pex.Grads()])
    _close(t.sq_norms, j.sq_norms)
    for k in p:
        _close(t.grads[k], j.grads[k])


@pytest.mark.parametrize("dt", DTYPES)
def test_mrope_matches(dt):
    """Angles (f32) on three distinct streams at qwen2-vl's full
    sections (16, 24, 24), and the rotation of (B, S, H, 128) heads."""
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 4096, (3, 2, 9))
    want = jrot.mrope_angles(jnp.asarray(pos, jnp.int32), 128, 1e6,
                             (16, 24, 24))
    got = trot.mrope_angles(torch.as_tensor(pos), 128, 1e6, (16, 24, 24))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, 64)
    _close(got, want, rtol=1e-6, atol=1e-6)
    jx, tx = _pair(rng, (2, 9, 3, 128), dt)
    _close_max(trot.apply_rope(tx, got), jrot.apply_rope(jx, want), _tol(dt))
    with pytest.raises(ValueError, match="M-RoPE"):
        trot.mrope_angles(torch.as_tensor(pos), 128, 1e6, (16, 24, 16))


ATTEND_CASES = {"softcap": dict(softcap=50.0),
                "window": dict(window=4),
                "softcap_window": dict(softcap=20.0, window=3,
                                       attn_scale=0.5)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("local_flag", [None, True, False])
@pytest.mark.parametrize("case", ATTEND_CASES)
def test_attend_matches(case, local_flag, dt):
    """``_attend`` with GQA (4 q heads on 2 kv heads), the softcap on the
    f32 logits, the window, and the per-layer ``local_flag``."""
    cfg_kw = dict(d_model=32, n_heads=4, n_kv=2, head_dim=8, head_multiple=1,
                  **ATTEND_CASES[case])
    jcfg, tcfg = jattn.AttnCfg(**cfg_kw), tattn.AttnCfg(**cfg_kw)
    assert tcfg.scale == jcfg.scale
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 11, 4, 8), dt, 3.0)
    jk, tk = _pair(rng, (2, 11, 2, 8), dt, 3.0)
    jv, tv = _pair(rng, (2, 11, 2, 8), dt)
    jflag = None if local_flag is None else jnp.asarray(local_flag)
    want = jattn._attend(jq, jk, jv, jcfg, 0, None, jflag)
    got = tattn._attend(tq, tk, tv, tcfg, local_flag)
    assert got.dtype == tq.dtype
    _close_max(got, want, _tol(dt))


def test_local_layers_actually_window():
    """Port of the reference's ``test_gemma2_local_layers_actually_window``:
    a local layer must not see beyond the window, a global one must."""
    cfg = tattn.AttnCfg(d_model=8, n_heads=1, n_kv=1, head_dim=8, window=2,
                        head_multiple=1)
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 6, 1, 8)),
                               dtype=torch.float32) for _ in range(3))
    out_local = tattn._attend(q, k, v, cfg, local_flag=True)
    out_global = tattn._attend(q, k, v, cfg, local_flag=False)
    # with window=2 the last query ignores k[:3]; perturbing k[0] must
    # change only the global variant
    k2 = k.clone()
    k2[:, 0] += 10.0
    out_local2 = tattn._attend(q, k2, v, cfg, local_flag=True)
    out_global2 = tattn._attend(q, k2, v, cfg, local_flag=False)
    torch.testing.assert_close(out_local[:, -1], out_local2[:, -1],
                               rtol=1e-6, atol=0)
    assert float((out_global[:, -1] - out_global2[:, -1]).abs().max()) > 1e-4


@pytest.mark.parametrize("dt", DTYPES)
def test_embed_scale_matches_exactly(dt):
    """× √d with the constant rounded to the embed's dtype first (bf16:
    √3584 → 59.75): one rounding of one product on both sides, so equal;
    a constant kept in f32 would round some products elsewhere."""
    jvc = jemb.VocabCfg(40, 3584, scale_by_sqrt_dim=True)
    tvc = temb.VocabCfg(40, 3584, scale_by_sqrt_dim=True)
    rng = np.random.default_rng(5)
    jt, tt = _pair(rng, (48, 3584), dt, 0.02)
    ids = rng.integers(0, 40, (2, 7))
    want = jemb.embed({"table": jt}, jnp.asarray(ids), tap=jpex.NULL, cfg=jvc)
    got = temb.embed({"table": tt}, torch.as_tensor(ids), tap=pex.NULL,
                     cfg=tvc)
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))
    if dt == "bf16":
        assert float(torch.tensor(3584 ** 0.5, dtype=torch.bfloat16)) == 59.75
        f32_const = (tt[torch.as_tensor(ids)].float() * 3584 ** 0.5).to(
            torch.bfloat16)
        assert not torch.equal(f32_const, got)


@pytest.mark.parametrize("dt", DTYPES)
def test_head_softcap_matches(dt):
    """cap · tanh(logits / cap) after the head's matmul, in the logits'
    dtype, then the vocab padding masked."""
    jvc = jemb.VocabCfg(100, 64, logit_softcap=30.0)
    tvc = temb.VocabCfg(100, 64, logit_softcap=30.0)
    assert tvc.vocab_p == jvc.vocab_p == 112
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (2, 5, 64), dt, 4.0)
    jw, tw = _pair(rng, (64, 112), dt, 1.0)
    want = jemb.lm_head({"w": jw}, jx, tap=jpex.NULL, cfg=jvc)
    got = temb.lm_head({"w": tw}, tx, tap=pex.NULL, cfg=tvc)
    assert got.dtype == tx.dtype
    assert float(got[..., :100].abs().max()) <= 30.0
    assert bool((got[..., 100:] < -1e29).all())
    _close_max(got[..., :100], want[..., :100], _tol(dt))


def _bf16_ulps(got, want):
    """|got − want| in bf16 steps, elementwise (both finite, same sign)."""
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    bits = [t.to(torch.bfloat16).view(torch.int16).int()
            for t in (got.float(), want)]
    return (bits[0] - bits[1]).abs()


def test_plus_one_gain_rounds_as_the_reference():
    """bf16: (1+g) formed in f32 and rounded to bf16 before it scales x.
    Rows of ±1 and ±3 have a mean square of exactly 4, so both packages
    normalise them to ±0.5 and ±1.5 exactly and the output shows only
    where the gain rounds: equal to the reference bit for bit, while a
    gain kept in f32 up to the product rounds some outputs elsewhere."""
    rng = np.random.default_rng(8)
    mags = np.array([1.0] * 40 + [3.0] * 24)
    x = np.stack([rng.permutation(mags) * rng.choice([-1.0, 1.0], 64)
                  for _ in range(6)]).reshape(2, 3, 64).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    jg, tg = _pair(rng, (64,), "bf16", 0.05)
    want = jnorms.rmsnorm({"g": jg}, jx, tap=jpex.NULL, plus_one=True)
    got = tnorms.rmsnorm({"g": tg}, tx, tap=pex.NULL, plus_one=True)
    assert int(_bf16_ulps(got, want).max()) == 0
    f32_gain = (tx.float() / 2 * (1.0 + tg.float())).to(torch.bfloat16)
    assert int(_bf16_ulps(f32_gain, want).max()) > 0


def test_head_softcap_rounds_as_the_reference():
    """bf16: cap · tanh(logits / cap) in the logits' dtype, rounding after
    each op as the reference does. Small integer inputs make the head's
    products and sums exact, so both packages softcap the same logits:
    within 1 bf16 step of the reference everywhere and off it at under 1%
    of the logits (the two tanh implementations may put a value on either
    side of a rounding step), while a softcap formed in f32 and rounded
    once is off at over 10%."""
    jvc = jemb.VocabCfg(100, 16, logit_softcap=30.0)
    tvc = temb.VocabCfg(100, 16, logit_softcap=30.0)
    rng = np.random.default_rng(9)
    x = rng.integers(-3, 4, (4, 16, 16)).astype(np.float32)
    w = rng.integers(-3, 4, (16, 112)).astype(np.float32)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    want = jemb.lm_head({"w": jnp.asarray(w, jnp.bfloat16)},
                        jnp.asarray(x, jnp.bfloat16), tap=jpex.NULL,
                        cfg=jvc)[..., :100]
    got = temb.lm_head({"w": tw}, tx, tap=pex.NULL, cfg=tvc)[..., :100]
    off = _bf16_ulps(got, want)
    assert int(off.max()) <= 1 and float((off > 0).float().mean()) < 0.01
    logits = (tx.float() @ tw.float())[..., :100]
    assert bool((logits.abs() <= 144).all())     # exact in bf16
    f32_cap = (30.0 * torch.tanh(logits / 30.0)).to(torch.bfloat16)
    assert float((_bf16_ulps(f32_cap, want) > 0).float().mean()) > 0.1


def test_attend_softcap_on_f32_logits():
    """bf16 q and k: the scaled logits and the softcap stay in f32, as in
    the reference. The port is within one bf16 step (2^-8) of the largest
    |value| of the reference's output, while a softcap applied to logits
    rounded to bf16 (steps of 0.5 at |logit| ≥ 64) moves the softmax, and
    the output, past the bf16 tolerance of 1e-2."""
    cfg_kw = dict(d_model=64, n_heads=2, n_kv=2, head_dim=32, head_multiple=1,
                  softcap=50.0)
    jcfg, tcfg = jattn.AttnCfg(**cfg_kw), tattn.AttnCfg(**cfg_kw)
    rng = np.random.default_rng(10)
    jq, tq = _pair(rng, (2, 64, 2, 32), "bf16", 6.0)
    jk, tk = _pair(rng, (2, 64, 2, 32), "bf16", 6.0)
    jv, tv = _pair(rng, (2, 64, 2, 32), "bf16")
    want = jattn._attend(jq, jk, jv, jcfg, 0, None, None)
    _close_max(tattn._attend(tq, tk, tv, tcfg), want, 2.0 ** -8)
    logits = (torch.einsum("bshd,bthd->bhst", tq.float(), tk.float())
              * tcfg.scale).to(torch.bfloat16).float()
    logits = 50.0 * torch.tanh(logits / 50.0)
    causal = torch.ones(64, 64, dtype=torch.bool).tril()
    probs = torch.softmax(logits.masked_fill(~causal, -1e30), dim=-1)
    rounded = torch.einsum("bhst,bthd->bshd", probs.to(torch.bfloat16), tv)
    with pytest.raises(AssertionError):
        _close_max(rounded.reshape(2, 64, 64), want, BF16_TOL)


def test_load_balance_loss_matches():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(64, 8)).astype(np.float32) * 2
    jcfg = jmoe.MoeCfg(d_model=16, d_ff=8, n_experts=8, top_k=2)
    tcfg = tmoe.MoeCfg(d_model=16, d_ff=8, n_experts=8, top_k=2)
    want = jmoe.load_balance_loss(jcfg, jnp.asarray(logits))
    got = tmoe.load_balance_loss(tcfg, torch.from_numpy(logits))
    _close(got, want, rtol=1e-6)
    # uniform router probabilities: E · Σ_e f_e / E = Σ_e f_e = top_k
    flat = tmoe.load_balance_loss(tcfg, torch.zeros(64, 8))
    assert abs(float(flat) - tcfg.top_k) < 1e-5
