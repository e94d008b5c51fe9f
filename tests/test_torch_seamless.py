"""The port's seamless-m4t-medium (``models/seamless.py``, the attention's
``causal=False`` and ``cross``) against the JAX reference's.

Units on the same numpy inputs and the reference's ``init`` parameters, in
f32 and bf16: the encoder's non-causal self-attention and the decoder's
cross-attention on an encoder memory of another length (q from the
decoder's rows, k and v from the memory's, no RoPE, no mask) — the output,
and each of the four taps' per-example stats as its own norm column of
``Engine.step([Norms()])`` on L_j = Σ y_j ⊙ r_j. The smoke step (2
encoder and 2 decoder blocks, the batch's ``src_frames``) against the
reference's jitted ``Engine.step`` in ``[Norms, Grads]`` (per group) and
``[Clip(1.0), Grads]``; the norms against the port's own oracle; the flash
gate (only the decoder's causal self-attention takes it); interop of the
``enc`` and ``dec`` stacks, batches, the published config and the
launcher's refusal. Tolerances as in ``tests/torch_family_parity.py``.
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
from repro.nn import attention as jattn
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry
from repro_torch.nn import attention as tattn
from repro_torch.nn.param import tree_map

ARCH = "seamless-m4t-medium"
B, S = 3, 12
T_MEM = 9
ATTN_TAPS = ("wq", "wk", "wv", "wo")
GROUPS = ("attn", "mlp", "norm", "embed", "head")


@pytest.fixture(scope="module")
def st():
    return fp.setup(ARCH, B, S)


def test_published_config():
    full, jfull = registry.get(ARCH).full(), jreg.get(ARCH).full()
    for k in ("name", "n_enc", "n_dec", "n_layers", "d_model", "n_heads",
              "kv_heads", "d_ff", "vocab", "dtype"):
        assert getattr(full, k) == getattr(jfull, k), k
    assert (full.n_layers, full.d_model, full.vocab) == (24, 1024, 256206)
    assert full.vocab_cfg.vocab_p == 256208
    for kw in ({}, {"cross": True}, {"causal": False}):
        a, ja = full.attn_cfg(**kw), jfull.attn_cfg(**kw)
        for k in ("d_model", "n_heads", "n_kv", "head_dim", "cross",
                  "causal", "d_out", "n_heads_p", "scale", "flash"):
            assert getattr(a, k) == getattr(ja, k), (kw, k)


def test_interop_round_trip_and_batch(st):
    """The reference's stacked ``enc`` and ``dec`` become lists of blocks
    and back; the batch's ``src_frames`` are the reference's draw."""
    fp.round_trip(st)
    cfg, params = st["cfg"], st["params"]
    assert len(params["enc"]) == cfg.n_enc and len(params["dec"]) \
        == cfg.n_dec
    assert tuple(st["batch"]["src_frames"].shape) == (B, S, cfg.d_model)


# --- units ---------------------------------------------------------------

@pytest.mark.parametrize("dt", fp.DTYPES)
@pytest.mark.parametrize("kind", ["noncausal", "cross"])
def test_attention_and_tap_stats_match(kind, dt, monkeypatch):
    """Non-causal self-attention (every query sees every key), and
    cross-attention on a memory of T = 9 rows under S = 12 queries."""
    cross = kind == "cross"
    kw = {"cross": True} if cross else {"causal": False}
    jcfg = jreg.get(ARCH).smoke().attn_cfg(**kw)
    cfg = registry.get(ARCH).smoke().attn_cfg(**kw)
    jdt = fp.DTYPES[dt][0]
    jp = unbox(jattn.init_attention(jax.random.PRNGKey(5), jcfg, dtype=jdt))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(6)
    jx, tx = fp.pair(rng, (B, S, jcfg.d_model), dt)
    jm, tm = fp.pair(rng, (B, T_MEM if cross else S, jcfg.d_model), dt)
    jr, tr = fp.pair(rng, (B, S, jcfg.d_model), dt)
    jb = {"x": jx, "m": jm, "r": jr}
    tb = {"x": tx, "m": tm, "r": tr}

    def jfn(p, b, tap):
        return jattn.attention(p, b["x"], tap=tap, cfg=jcfg,
                               memory=b["m"] if cross else None)[0]

    def tfn(p, b, tap):
        return tattn.attention(p, b["x"], tap=tap, cfg=cfg,
                               memory=b["m"] if cross else None)

    got = tfn(tp, tb, pex.NULL)
    assert got.dtype == fp.DTYPES[dt][1]
    fp.close_dt(got, jfn(jp, jb, jpex.NULL), dt)
    causal = dataclasses.replace(cfg, causal=True, cross=False)
    if not cross:   # the mask is off: a causal run differs
        assert float((tattn.attention(tp, tx, tap=pex.NULL, cfg=causal)
                      - got).abs().max()) > 1e-2

    def jloss(p, b, tap):
        return jnp.sum((jfn(p, b, tap) * b["r"]).astype(jnp.float32),
                       axis=(1, 2)), {}

    def tloss(p, b, tap):
        return torch.sum((tfn(p, b, tap) * b["r"]).float(), dim=(1, 2)), {}

    fp.per_call_groups(monkeypatch, ATTN_TAPS)
    eng = jpex.Engine(jpex.PexSpec(groups=ATTN_TAPS))
    want = jax.jit(lambda p, b: eng.step(jloss, p, b, [jpex.Norms()]))(
        jp, jb).sq_norms
    got = pex.Engine(pex.PexSpec(groups=ATTN_TAPS)).step(
        tloss, tp, tb, [pex.Norms()]).sq_norms
    assert got.shape == (B, len(ATTN_TAPS)) and bool((got > 0).all())
    if dt == "f32":
        fp.close(got, want, fp.RTOL)
        return
    truth = pex.Engine(pex.PexSpec(groups=ATTN_TAPS)).step(
        tloss, tree_map(lambda x: x.float(), tp),
        {k: v.float() for k, v in tb.items()}, [pex.Norms()]).sq_norms
    fp.close_stats_bf16(got, want, truth)


def test_cross_attention_needs_memory_and_cache_raises():
    cfg = registry.get(ARCH).smoke().attn_cfg(cross=True)
    p = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32, device="cpu")
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.raises(ValueError, match="memory"):
        tattn.attention(p, x, tap=pex.NULL, cfg=cfg)
    # a cross cache must hold the encoder's k and v (the decode on one is
    # held against the reference in tests/test_torch_serve_cache.py)
    with pytest.raises(KeyError, match="k"):
        tattn.attention(p, x, tap=pex.NULL, cfg=cfg, memory=x, cache={})


# --- the smoke step -------------------------------------------------------

def test_step_norms_and_grads_match(st):
    """[Norms, Grads] with one norm column per group: the encoder's and
    decoder's attention (self and cross) and MLPs, the layernorms, the
    embedding and the head."""
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


def test_scope_is_whole_and_norms_match_own_oracle(st):
    """No seamless leaf is declared untapped, in either package."""
    assert fp.scope_matches_reference(st) == 0
    assert registry.untapped_allowlist(ARCH) == ()
    fp.norms_match_own_oracle(st)


def test_flash_gate_takes_only_decoder_self_attention(monkeypatch):
    """With ``AttnCfg.flash`` at S = 128 the encoder (``causal=False``) and
    the cross-attention close the reference's gate; each decoder block's
    causal self-attention goes through ``ops.flash_attention_vjp`` (its
    plain version on the CPU), and the loss is the unfused one's."""
    spec = registry.get(ARCH)
    cfg = spec.smoke()
    calls = []
    vjp = tops.flash_attention_vjp

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return vjp(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention_vjp", counted)
    orig = type(cfg).attn_cfg

    def with_flash(self, **kw):
        return dataclasses.replace(orig(self, **kw), flash=True)

    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("t", "train", 128, 2), 1, device="cpu")
    loss = registry.make_loss_fn_v2(spec, cfg)
    plain, _ = loss(params, batch, pex.NULL)
    assert calls == []
    monkeypatch.setattr(type(cfg), "attn_cfg", with_flash)
    flash, _ = loss(params, batch, pex.NULL)
    assert len(calls) == cfg.n_dec
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=0)


def test_launcher_refuses_seamless():
    """``SyntheticLM`` has no source frames: a clear error, not a
    ``KeyError``."""
    with pytest.raises(ValueError, match="src_frames"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1",
                      "--device", "cpu"])
