"""The port's zamba2 (``nn/ssm.py``, the attention's ``d_out``,
``models/zamba2.py``) against the JAX reference's.

Units on the same numpy inputs and the reference's ``init`` parameters, in
f32 and bf16: ``_causal_conv``, ``ssm`` (the output, and the stats of its
four taps — in_proj, the dt_bias bias tap on the f32 Δ, the gated norm's
``norm_g`` scale tap and out_proj — each its own norm column of
``Engine.step([Norms()])`` on L_j = Σ y_j ⊙ r_j) and the shared block's
attention over 2·d_model with ``d_out = d_model``. The chunked SSD
recurrence against the plain per-step loop with ``CHUNK`` forced to 3 on
S = 8: outputs bit for bit, input gradients within 1e-6, and the same
through ``Engine.step`` and the port's ``vmap(grad)`` oracle. The smoke
step (2 groups of 2 mamba blocks, the shared block after each, 1 tail
block) against the reference's jitted ``Engine.step`` in ``[Norms,
Grads]`` (per group) and ``[Clip(1.0), Grads]``, the shared block's
parameters among the gradients; the declared untapped scope against the
reference's; interop of the (G, K) and tail stacks, batches, the published
config and the launcher. Tolerances as in ``tests/torch_family_parity.py``.
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
from repro.nn import ssm as jssm
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.core import naive
from repro_torch.core import taps as tT
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry
from repro_torch.nn import attention as tattn
from repro_torch.nn import ssm as tssm
from repro_torch.nn.param import tree_flatten, tree_map

ARCH = "zamba2-7b"
B, S = 3, 12
SSM_TAPS = ("in_proj", "dt_bias", "norm_g", "out_proj")
ATTN_TAPS = ("wq", "wk", "wv", "wo")
GROUPS = ("ssm", "norm", "embed", "head")


@pytest.fixture(scope="module")
def st():
    return fp.setup(ARCH, B, S)


def test_published_config():
    full, jfull = registry.get(ARCH).full(), jreg.get(ARCH).full()
    for k in ("name", "n_layers", "d_model", "vocab", "d_ff", "n_heads",
              "kv_heads", "share_every", "rms_eps", "dtype", "n_groups",
              "n_tail"):
        assert getattr(full, k) == getattr(jfull, k), k
    assert (full.n_layers, full.d_model, full.vocab, full.ssm.d_state) \
        == (81, 3584, 32000, 64)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(jfull.ssm)
    a, ja = full.attn_cfg, jfull.attn_cfg
    for k in ("d_model", "n_heads", "n_kv", "head_dim", "d_out",
              "rope_theta", "n_heads_p", "scale", "flash"):
        assert getattr(a, k) == getattr(ja, k), k
    assert (a.d_model, a.head_dim, a.d_out) == (7168, 224, 3584)
    assert 2 * full.ssm.d_inner + 2 * full.ssm.d_state + full.ssm.n_heads \
        == 14576


def test_interop_round_trip_and_batch(st):
    """The reference's (G, K, ...) ``blocks`` become G lists of K blocks,
    its (T, ...) ``tail`` a list, and back."""
    fp.round_trip(st)
    cfg, params = st["cfg"], st["params"]
    assert [len(g) for g in params["blocks"]] == [cfg.share_every] \
        * cfg.n_groups
    assert len(params["tail"]) == cfg.n_tail == 1
    assert "ssm" in params["blocks"][1][0] and "attn" in params["shared"]


def test_bf16_dtypes_kept_by_init_adamw_and_noise():
    """In bf16, a_log, d and dt_bias stay f32 and every other leaf is
    bf16, in both packages' ``init``; one AdamW update and the in-place
    noise add keep every leaf's dtype."""
    fp.check_bf16_dtypes(ARCH, {"a_log", "d", "dt_bias"})


# --- units ---------------------------------------------------------------

@pytest.mark.parametrize("dt", fp.DTYPES)
def test_causal_conv_matches(dt):
    rng = np.random.default_rng(0)
    jx, tx = fp.pair(rng, (2, 9, 24), dt)
    jw, tw = fp.pair(rng, (4, 24), dt, 0.5)
    jb, tb = fp.pair(rng, (24,), dt)
    want, jtail = jssm._causal_conv(jx, jw, jb, None)
    got, tail = tssm._causal_conv(tx, tw, tb)
    assert got.dtype == tx.dtype
    fp.close_dt(got, want, dt)
    fp.close_dt(tail, jtail, dt)


def _stats(dt, monkeypatch, jfn, tfn, jp, tp, d_in, taps, seed):
    """The unit's output and each tap's stat (one norm column per tap
    call) on L_j = Σ y_j ⊙ r_j."""
    rng = np.random.default_rng(seed)
    jx, tx = fp.pair(rng, (B, S, d_in), dt)
    want = jfn(jp, jx, jpex.NULL)
    got = tfn(tp, tx, pex.NULL)
    assert got.dtype == fp.DTYPES[dt][1]
    fp.close_dt(got, want, dt)
    jr, tr = fp.pair(rng, tuple(got.shape), dt)

    def jloss(p, b, tap):
        out = jfn(p, b["x"], tap)
        return jnp.sum((out * b["r"]).astype(jnp.float32), axis=(1, 2)), {}

    def tloss(p, b, tap):
        return torch.sum((tfn(p, b["x"], tap) * b["r"]).float(),
                         dim=(1, 2)), {}

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
    truth = pex.Engine(pex.PexSpec(groups=taps)).step(
        tloss, tree_map(lambda x: x.float(), tp),
        {"x": tx.float(), "r": tr.float()}, [pex.Norms()]).sq_norms
    fp.close_stats_bf16(got, want, truth)


def _carry(jp):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


@pytest.mark.parametrize("dt", fp.DTYPES)
def test_ssm_and_tap_stats_match(dt, monkeypatch):
    jcfg = jreg.get(ARCH).smoke().ssm
    cfg = registry.get(ARCH).smoke().ssm
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = unbox(jssm.init_ssm(jax.random.PRNGKey(1), jcfg,
                             dtype=fp.DTYPES[dt][0]))
    rng = np.random.default_rng(1)
    jp["d"] = jnp.asarray(rng.normal(1.0, 0.5, jp["d"].shape), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(size=jp["dt_bias"].shape) * 0.5,
                                jnp.float32)
    _stats(dt, monkeypatch,
           lambda p, x, tap: jssm.ssm(p, x, tap=tap, cfg=jcfg)[0],
           lambda p, x, tap: tssm.ssm(p, x, tap=tap, cfg=cfg),
           jp, _carry(jp), jcfg.d_model, SSM_TAPS, 2)


@pytest.mark.parametrize("dt", fp.DTYPES)
def test_shared_attention_d_out_matches(dt, monkeypatch):
    """The shared block's attention: 2·d_model in (4 heads padded to 16),
    d_out = d_model out, causal with RoPE."""
    jcfg = jreg.get(ARCH).smoke().attn_cfg
    cfg = registry.get(ARCH).smoke().attn_cfg
    assert cfg.d_out == jcfg.d_out == 64 and cfg.d_model == 128
    jp = unbox(jattn.init_attention(jax.random.PRNGKey(3), jcfg,
                                    dtype=fp.DTYPES[dt][0]))
    tp = _carry(jp)
    assert tuple(tp["wo"]["w"].shape) == (cfg.n_heads_p * cfg.head_dim, 64)
    _stats(dt, monkeypatch,
           lambda p, x, tap: jattn.attention(p, x, tap=tap, cfg=jcfg)[0],
           lambda p, x, tap: tattn.attention(p, x, tap=tap, cfg=cfg),
           jp, tp, jcfg.d_model, ATTN_TAPS, 4)


def test_decode_state_raises():
    """A decode state without its buffers raises; one from
    ``init_ssm_state`` is written in place (the decode itself is held
    against the reference in ``tests/test_torch_serve_cache.py``)."""
    cfg = registry.get(ARCH).smoke().ssm
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32, device="cpu")
    x = torch.ones(1, 2, cfg.d_model)
    with pytest.raises(KeyError, match="conv"):
        tssm.ssm(p, x, tap=pex.NULL, cfg=cfg, state={})
    state = tssm.init_ssm_state(1, cfg, dtype=torch.float32, device="cpu")
    tssm.ssm(p, x, tap=pex.NULL, cfg=cfg, state=state)
    assert bool(state["h"].any()) and bool(state["conv"].any())


# --- the chunked recurrence ---------------------------------------------

def _ssd_inputs(seed=4):
    rng = np.random.default_rng(seed)
    b, s, nh, hd, ds = 2, 8, 3, 4, 5

    def draw(*shape, lo=None):
        x = rng.uniform(lo, 1.0, shape) if lo is not None \
            else rng.normal(size=shape)
        return torch.from_numpy(x).float()
    return [draw(b, s, nh, hd), draw(b, s, ds), draw(b, s, ds),
            draw(b, s, nh, lo=0.1), draw(b, s, nh, lo=0.5)]


def test_ssd_chunks_match_the_plain_loop(monkeypatch):
    """CHUNK = 3 on S = 8 (chunks of 3, 3 and 2 steps): the forward gives
    the plain loop's bits, the hand-written backward its input gradients
    within 1e-6 (in f64 within 1e-12), and a second backward over the
    retained graph the same gradients again."""
    monkeypatch.setattr(tssm, "CHUNK", 3)
    ins = [x.requires_grad_() for x in _ssd_inputs()]
    plain, chunked = tssm.ssd_loop(*ins), tssm.ssd(*ins)
    assert torch.equal(plain, chunked)
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=plain.shape)).float()
    want = torch.autograd.grad(plain, ins, dy)
    got = torch.autograd.grad(chunked, ins, dy, retain_graph=True)
    again = torch.autograd.grad(chunked, ins, dy)
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        assert torch.equal(g, a)
    # in f64 the hand-written backward is autograd's to rounding: what
    # separates the two in f32 is the order of the sums, not the algebra
    ins64 = [x.detach().double().requires_grad_() for x in ins]
    want64 = torch.autograd.grad(tssm.ssd_loop(*ins64), ins64, dy.double())
    got64 = torch.autograd.grad(tssm.ssd(*ins64), ins64, dy.double())
    for g, w in zip(got64, want64):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_ssd_chunks_through_engine_step_and_oracle(monkeypatch):
    """The smoke model at S = 8 with CHUNK = 3, against the same on the
    plain per-step loop: ``Engine.step([Norms, Clip(1.0)])`` (two backward
    passes on one graph: the losses bit for bit, the norms within 1e-6,
    the clipped gradients within 1e-5 of each leaf's largest |value|) and
    the port's ``vmap(grad)`` oracle (per-example gradients within 1e-5)."""
    st = fp.setup(ARCH, B, 8)
    loss = st["loss"]

    def single(p, ex):
        return loss(p, {k: v[None] for k, v in ex.items()}, pex.NULL)[0][0]

    def run():
        res = pex.Engine(pex.PexSpec()).step(
            loss, st["params"], st["batch"], [pex.Norms(), pex.Clip(1.0)])
        return res, naive.per_example_grads(single, st["params"],
                                            st["batch"])

    monkeypatch.setattr(tssm, "CHUNK", 3)
    got, got_pe = run()
    monkeypatch.setattr(tssm, "ssd", tssm.ssd_loop)
    want, want_pe = run()
    assert torch.equal(got.loss_vec, want.loss_vec)
    torch.testing.assert_close(got.sq_norms, want.sq_norms, rtol=1e-6,
                               atol=0)
    for a, b in ((got.grads, want.grads), (got_pe, want_pe)):
        for g, w in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))


# --- the smoke step -------------------------------------------------------

def test_step_norms_and_grads_match(st):
    """[Norms, Grads] with one norm column per group; the shared block's
    parameters (no stat) among the gradients, summed over its two uses."""
    t, j = fp.steps(st, [pex.Norms(), pex.Grads()],
                    [jpex.Norms(), jpex.Grads()], groups=GROUPS)
    assert t.sq_norms.shape == (B, len(GROUPS))
    assert bool((t.sq_norms > 0).all())
    fp.close(t.loss_vec, j.loss_vec)
    fp.close(t.sq_norms, j.sq_norms)
    fp.close_trees(t.grads, j.grads)
    assert all(bool(g.abs().max() > 0)
               for g in tree_flatten(t.grads["shared"])[0])


def test_step_clip_matches(st):
    t, j = fp.steps(st, [pex.Clip(1.0), pex.Grads()],
                    [jpex.Clip(1.0), jpex.Grads()])
    fp.close(t.sq_norms, j.sq_norms)
    fp.close(t.clip_coef, j.clip_coef)
    assert float(t.clip_coef.max()) < 1.0
    fp.close_trees(t.grads, j.grads)


def test_scope_matches_reference(st, monkeypatch):
    """The shared block's 9 leaves and a_log, d, conv_w and conv_b of the
    grouped and the tail stack: the 17 leaves the reference's scope filter
    drops; the port's norms equal its own oracle over the rest, and the
    shared block takes no stat: every live dense tap is a mamba block's
    in_proj or out_proj (in the forward and again in the norms backward's
    recompute of each checkpointed mamba block), or the head."""
    assert fp.scope_matches_reference(st) == 17
    fp.norms_match_own_oracle(st)
    live = []
    dense = tT.Tap.dense

    def spy(self, h, w, **kw):
        if self.live:
            live.append(tuple(w.shape))
        return dense(self, h, w, **kw)

    monkeypatch.setattr(tT.Tap, "dense", spy)
    pex.Engine(pex.PexSpec()).step(st["loss"], st["params"], st["batch"],
                                   [pex.Norms()])
    cfg = st["cfg"]
    p = st["params"]["blocks"][0][0]["ssm"]
    n_blocks = cfg.n_groups * cfg.share_every + cfg.n_tail
    assert cfg.remat
    assert sorted(live) == sorted(
        [tuple(p["in_proj"]["w"].shape), tuple(p["out_proj"]["w"].shape)]
        * n_blocks * (1 + 1) + [(cfg.d_model, cfg.vocab_cfg.vocab_p)])


def test_launcher_trains_zamba2(capsys):
    ms = tlaunch.main(["--arch", ARCH, "--smoke", "--mode", "clip",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--device", "cpu"])
    assert len(ms) == 1 and np.isfinite(ms[0]["loss"])
    assert "[1] loss=" in capsys.readouterr().out


# --- batch-size rounding: where the norm error of the open check grows ----

def _block_cotangents_port(params, batch, cfg):
    """∂L/∂x at each block's input (mamba blocks and the shared block's
    uses, in order) of example 0, L = Σ loss_vec, the port's blocks run as
    ``zamba2._run`` runs them."""
    from repro_torch.models import zamba2 as tz
    from repro_torch.nn.embedding import embed, lm_head, per_example_xent
    from repro_torch.nn.norms import rmsnorm
    n = cfg.n_groups * (cfg.share_every + 1) + cfg.n_tail
    eps = [torch.zeros(batch["ids"].shape + (cfg.d_model,),
                       requires_grad=True) for _ in range(n)]
    it = iter(eps)
    x = embed(params["embed"], batch["ids"], tap=tT.NULL, cfg=cfg.vocab_cfg)
    x0 = x
    for group in params["blocks"]:
        for p in group:
            x = tz._mamba_block(p, x + next(it), tT.NULL, cfg)
        x = tz._shared_block(params["shared"], x + next(it), x0, cfg)
    for p in params.get("tail", []):
        x = tz._mamba_block(p, x + next(it), tT.NULL, cfg)
    x = rmsnorm(params["ln_f"], x, tap=tT.NULL, eps=cfg.rms_eps)
    logits = lm_head(params["head"], x, tap=tT.NULL, cfg=cfg.vocab_cfg)
    loss = per_example_xent(logits, batch["labels"]).sum()
    return [g[0].numpy() for g in torch.autograd.grad(loss, eps)]


def _block_cotangents_ref(params, batch, cfg):
    """The same cotangents of the reference's blocks (its ``_run``'s
    order, the stacked parameters sliced per block), jitted."""
    from repro.core import taps as jT
    from repro.models import zamba2 as jz
    from repro.nn import embedding as jE
    from repro.nn import norms as jN
    n = cfg.n_groups * (cfg.share_every + 1) + cfg.n_tail

    def loss(eps):
        it = iter(eps)
        x = jE.embed(params["embed"], batch["ids"], tap=jT.NULL,
                     cfg=cfg.vocab_cfg)
        x0 = x
        for g in range(cfg.n_groups):
            for i in range(cfg.share_every):
                p = jax.tree_util.tree_map(lambda v: v[g][i],
                                           params["blocks"])
                x, _ = jz._mamba_block(p, x + next(it), jT.NULL, cfg)
            x, _ = jz._shared_block(params["shared"], x + next(it), x0, cfg)
        for i in range(cfg.n_tail):
            p = jax.tree_util.tree_map(lambda v: v[i], params["tail"])
            x, _ = jz._mamba_block(p, x + next(it), jT.NULL, cfg)
        x = jN.rmsnorm(params["ln_f"], x, tap=jT.NULL, eps=cfg.rms_eps)
        logits = jE.lm_head(params["head"], x, tap=jT.NULL,
                            cfg=cfg.vocab_cfg)
        return jnp.sum(jE.per_example_xent(logits, batch["labels"]))
    eps = [jnp.zeros(batch["ids"].shape + (cfg.d_model,)) for _ in range(n)]
    return [np.asarray(g[0]) for g in jax.jit(jax.grad(loss))(eps)]


def test_batch_size_rounding_no_larger_than_reference():
    """The open check on zamba2's f32 norm error (smoke config, f32, B=4,
    S=32): example 0's fused norms move between B=4 and B=1 — in the
    reference 1.7e-5, in the port 4.3e-6 — and so does Z̄ at each block's
    input, in both packages from the first block on, the port's never past
    the reference's. The port's norms at B=1 are its ``vmap(grad)``
    oracle's (2.5e-7), which computes each example alone; the reference's
    ``vmap`` oracle runs batched and shares the batch's rounding, which is
    why it reads closer to its fused norms. So the error is f32 rounding
    that depends on the batch size, not a change of form in the port:
    held here at no more than 2× the reference's at every block and in
    the norms."""
    st = fp.setup(ARCH, 4, 32)
    cfg = st["cfg"]
    jcfg = jreg.get(ARCH).smoke()
    b1 = {k: v[:1] for k, v in st["batch"].items()}
    jb1 = {k: v[:1] for k, v in st["jbatch"].items()}

    def move(a4, a1):
        return float(np.abs(a4 - a1).max() / np.abs(a1).max())
    port = [move(a, b) for a, b in zip(
        _block_cotangents_port(st["params"], st["batch"], cfg),
        _block_cotangents_port(st["params"], b1, cfg))]
    ref = [move(a, b) for a, b in zip(
        _block_cotangents_ref(st["jparams"], st["jbatch"], jcfg),
        _block_cotangents_ref(st["jparams"], jb1, jcfg))]
    assert len(port) == len(ref) == 7
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p <= 2 * r, (i, port, ref)

    def norms(eng_step, batch):
        return np.asarray(eng_step(batch).sq_norms.sum(-1))[0]
    t_step = lambda b: pex.Engine(pex.PexSpec()).step(
        st["loss"], st["params"], b, [pex.Norms()])
    eng = jpex.Engine(jpex.PexSpec())
    j_step = jax.jit(lambda b: eng.step(st["jloss"], st["jparams"], b,
                                        [jpex.Norms()]))
    p_move = abs(norms(t_step, st["batch"]) / norms(t_step, b1) - 1)
    r_move = abs(norms(j_step, st["jbatch"]) / norms(j_step, jb1) - 1)
    assert 0 < p_move <= 2 * r_move, (p_move, r_move)
