"""The port's training loop and its parts against the reference's.

Schedules, Adafactor, one AdamW update and the int8 error-feedback
compression are compared on the same numpy inputs; the AdamW update's
loop over chunks and the in-place noise add (both bounded in memory) are
held bit for bit against the whole-leaf and out-of-place forms they
replaced; the data pipeline's batches must equal the
reference's bit for bit; and the port's ``Trainer`` runs 10 steps of the
llama3.2-1b smoke config in f32 (B=8, S=16) beside the reference's, from
the reference's ``init`` parameters, in modes plain, norms and clip (noise
off) and with ``[Norms, Clip, GNS]``, and the gemma2-9b smoke config
(softcaps, local/global layers, (1+g) and sandwich norms, × √d) in mode
clip: each step's loss, ``norm_mean``, ``norm_max`` and ``gns`` agree at
1e-4 relative. A loss poisoned for some
examples is quarantined as the reference does. A one-rank mesh trains bit
for bit as the local trainer does, and saves and restores its checkpoints
(``tests/test_torch_ckpt.py`` holds the resume bit for bit). The launcher
runs each mode, saves with ``--ckpt-dir`` and resumes with ``--resume``,
and each arch of the transformer family (deepseek-v2-236b's MLA, dense
prefix and MoE among them), on the CPU.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_parity as tdp
from repro.core import passes as jpasses
from repro.core import plan as jplan
from repro.core.taps import PexSpec as JPexSpec
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro.optim import adafactor as jada
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro.train import trainer as jtrainer
from repro_torch import interop
from repro_torch.core import passes
from repro_torch.core import plan as tplan
from repro_torch.core.taps import PexSpec
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import sharding as shd
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.optim import adafactor as tada
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedule as tsched
from repro_torch.train import trainer as ttrainer

ARCH = "llama3.2-1b"
B, S, STEPS = 8, 16, 10


def _np_params(seed=0, arch=ARCH):
    jspec = jreg.get(arch)
    return unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(seed),
                                                jspec.smoke()))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# --- schedules, Adafactor, compression --------------------------------------

@pytest.mark.parametrize("name, args", [("linear_warmup_cosine", (10, 100)),
                                        ("linear_warmup_cosine", (0, 150)),
                                        ("constant", ()), ("rsqrt", (10,))])
def test_schedule_matches_reference(name, args):
    steps = np.arange(201)
    want = np.asarray(getattr(jsched, name)(*args)(jnp.asarray(steps)))
    f = getattr(tsched, name)(*args)
    got = np.asarray([f(int(t)) for t in steps])
    assert all(isinstance(f(int(t)), float) for t in (0, 5, 200))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adafactor_matches_reference():
    """Over leaves of each rank (the RMS of the update clipping and of the
    relative step is taken per leaf, so the trees hold the same leaves:
    the reference's stacked (L, ...) block leaves would take one RMS over
    all layers where the port's per-layer leaves take one each)."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(16, 24)).astype(np.float32),
              "b": rng.normal(size=(24,)).astype(np.float32) * 0.1,
              "e": rng.normal(size=(3, 8, 5)).astype(np.float32),
              "s": np.asarray(0.7, np.float32)}
    jcfg = jada.AdafactorConfig(lr=1e-2, weight_decay=0.1,
                                schedule=jsched.linear_warmup_cosine(2, 10))
    tcfg = tada.AdafactorConfig(lr=1e-2, weight_decay=0.1,
                                schedule=tsched.linear_warmup_cosine(2, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jada.init(jp)
    tp = interop.params_from_numpy(params, device="cpu")
    ts = tada.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        jp, js = jada.update(jcfg, js, jp,
                             jax.tree_util.tree_map(jnp.asarray, grads))
        tp, ts = tada.update(tcfg, ts, tp,
                             interop.params_from_numpy(grads, device="cpu"))
    assert ts.step == 3
    for got, want in ((tp, jp), (ts.vr, js.vr), (ts.vc, js.vc)):
        for g, w in zip(_leaves(interop.params_to_numpy(got)), _leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    assert tp["s"].ndim == 0 and ts.vc["s"].ndim == 0


# --- AdamW and the noise add: bounded in memory, bitwise the same ----------

def _whole_leaf_update(cfg, state, params, grads):
    """The AdamW update as it ran before its loop went over chunks: each
    expression over the whole leaf."""
    step = state.step + 1
    scale = 1.0
    if cfg.global_clip is not None:
        gn = adamw.global_norm(grads)
        scale = torch.clamp(cfg.global_clip / (gn + 1e-9), max=1.0)
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    with torch.no_grad():
        for p, g, m, v in zip(*(tree_leaves(t) for t in (
                params, grads, state.mu, state.nu))):
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            pf = p.to(torch.float32)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    return params, adamw.AdamWState(step, state.mu, state.nu)


@pytest.mark.parametrize("global_clip", [1.0, None])
def test_adamw_chunked_update_is_bitwise_the_whole_leaf_one(global_clip,
                                                            monkeypatch):
    """With the chunk constant forced to 5 elements (so every leaf but the
    scalar spans chunks, most with a ragged last one), three updates give
    parameters and moments equal bit for bit to the whole-leaf formula's,
    on f32 and bf16 leaves, a 0-d leaf and a non-contiguous gradient."""
    monkeypatch.setattr(adamw, "CHUNK", 5)
    gen = torch.Generator().manual_seed(3)

    def tree(dtype=None):
        out = {"w": torch.randn(7, 9, generator=gen),
               "e": torch.randn(3, 4, 6, generator=gen),
               "b": [torch.randn(11, generator=gen)],
               "s": torch.randn((), generator=gen),
               "h": torch.randn(13, 5, generator=gen).to(torch.bfloat16)}
        return out if dtype is None else {
            k: (v.to(dtype) if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}

    params = tree()
    twin = tree_map(torch.clone, params)
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1,
                            global_clip=global_clip,
                            schedule=tsched.linear_warmup_cosine(1, 5))
    state, twin_state = adamw.init(params), adamw.init(twin)
    for _ in range(3):
        grads = tree()
        grads["w"] = torch.randn(9, 7, generator=gen).t()  # not contiguous
        grads["h"] = grads["h"].to(torch.bfloat16)
        params, state = adamw.update(cfg, state, params, grads)
        twin, twin_state = _whole_leaf_update(cfg, twin_state, twin, grads)
        assert state.step == twin_state.step
        for got, want in ((params, twin), (state.mu, twin_state.mu),
                          (state.nu, twin_state.nu)):
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_adamw_update_refuses_a_non_contiguous_parameter():
    """The update writes each parameter through a flat view, so a
    transposed parameter leaf is refused by name, before anything
    changes."""
    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(6, generator=gen),
              "w": torch.randn(9, 7, generator=gen).t()}
    state = adamw.init(params)
    before = tree_map(torch.clone, params)
    grads = tree_map(torch.ones_like, params)
    with pytest.raises(ValueError, match=r"\(7, 9\).*not contiguous"):
        adamw.update(adamw.AdamWConfig(), state, params, grads)
    for k in params:
        assert torch.equal(params[k], before[k])


def test_adamw_one_update_matches_reference():
    """One update of the llama3.2-1b smoke parameters against the
    reference's ``optim/adamw.update``, global clip and weight decay on:
    parameters and both moments at 1e-6."""
    jp = _np_params()
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(8)
    grads = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), np_p)
    kw = dict(lr=1e-2, weight_decay=0.1, global_clip=1.0)
    jp, js = jadamw.update(jadamw.AdamWConfig(**kw), jadamw.init(jp), jp,
                           jax.tree_util.tree_map(jnp.asarray, grads))
    tp = interop.params_from_numpy(np_p, device="cpu")
    tp, ts = adamw.update(adamw.AdamWConfig(**kw), adamw.init(tp), tp,
                          interop.params_from_numpy(grads, device="cpu"))
    assert ts.step == 1
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for g, w in zip(_leaves(interop.params_to_numpy(got)), _leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_add_in_place_is_bitwise_the_out_of_place_sum(dtype,
                                                            monkeypatch):
    """The reference's own N(0, 1) sample, injected at
    ``passes._standard_normal``, added in place: each leaf equals
    ``g + (σ·C·sample).to(g.dtype)`` bit for bit, and the caller's tree
    is the one returned."""
    shapes = {"a": (6, 5), "b": (17,), "c": (2, 3, 4)}
    key = jax.random.PRNGKey(9)
    sample = jpasses.add_grad_noise(
        {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}, 1.0, 1.0,
        key)
    draws = [torch.tensor(np.asarray(sample[k])) for k in sorted(shapes)]
    rng = np.random.default_rng(6)
    grads = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
             .to(dtype) for k, s in shapes.items()}
    sigma, c = 0.1, 2.0
    want = {k: grads[k] + (sigma * c * d).to(dtype)
            for k, d in zip(sorted(shapes), draws)}
    fresh = [d.clone() for d in draws]

    def injected(shape, generator, device):
        d = fresh.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return d

    monkeypatch.setattr(passes, "_standard_normal", injected)
    leaves = dict(grads)
    out = passes.add_grad_noise(grads, sigma, c, torch.Generator())
    assert out is grads and fresh == []
    for k in shapes:
        assert out[k] is leaves[k]
        assert out[k].dtype == dtype and torch.equal(out[k], want[k])


def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 33), "b": (7,), "c": (3, 4, 5)}
    jerr = jgc.init_error({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = tgc.init_error({k: torch.zeros(s) for k, s in shapes.items()})
    for call in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * 10 ** call
             for k, s in shapes.items()}
        if call == 1:
            g["b"][3] = np.nan          # a non-finite tensor passes through
        jout, jerr = jgc.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tout, terr = tgc.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in shapes:
            for got, want in ((tout[k], jout[k]), (terr[k], jerr[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.nanmax(np.abs(want)), equal_nan=True)


# --- the data pipeline -------------------------------------------------------

@pytest.mark.parametrize("seed, step, host, hosts", [(0, 0, 0, 1),
                                                     (0, 7, 1, 2),
                                                     (3, 123, 3, 4),
                                                     (11, 2, 0, 2)])
def test_synthetic_lm_batches_equal_reference(seed, step, host, hosts):
    cfg = dict(vocab=1000, seq=40, global_batch=8, seed=seed)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**cfg), host, hosts)
    got = tpipe.SyntheticLM(tpipe.DataConfig(**cfg), host, hosts,
                            device="cpu")
    w, g = want.batch_at(step), got.batch_at(step)
    assert sorted(g) == ["ids", "labels"]
    for k in w:
        assert g[k].device.type == "cpu" and not g[k].is_floating_point()
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_logical_sharded_lm_equals_reference():
    cfg = dict(vocab=500, seq=24, global_batch=8, seed=4)
    want = jpipe.LogicalShardedLM(jpipe.DataConfig(**cfg), 4)
    got = tpipe.LogicalShardedLM(tpipe.DataConfig(**cfg), 4, device="cpu")
    owned = tpipe.assign_logical_shards(4, [5, 2])
    assert owned == jpipe.assign_logical_shards(4, [5, 2])
    for step in (0, 9):
        for g, w in ((got.batch_at(step), want.batch_at(step)),
                     (got.global_batch_at(step, owned),
                      want.global_batch_at(step, owned)),
                     (got.shard_batch_at(step, [3, 1]),
                      want.shard_batch_at(step, [3, 1]))):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match="divide"):
            mod.assign_logical_shards(4, [0, 1, 2])
        with pytest.raises(ValueError, match="no active hosts"):
            mod.assign_logical_shards(4, [])
        with pytest.raises(ValueError, match="divisible"):
            mod.LogicalShardedLM(mod.DataConfig(**cfg), 3)


def test_pipeline_state_round_trip_and_errors():
    for mod in (tpipe, jpipe):
        st = mod.PipelineState(step=17, seed=3)
        assert mod.PipelineState.from_dict(st.to_dict()) == st
        assert st.to_dict() == {"step": 17, "seed": 3}
        with pytest.raises(ValueError, match=r"missing key\(s\) \['seed'\]"):
            mod.PipelineState.from_dict({"step": 1})


# --- the trainer against the reference's -------------------------------------

MODES = ("plain", "norms", "clip", "norms+clip+gns")


def _consumers(mode, port):
    if mode == "norms+clip+gns":
        p = tplan if port else jplan
        return (p.Norms(), p.Clip(1.0), p.GNS())
    mod = ttrainer if port else jtrainer
    return mod.consumers_for_mode(mode, B, clip_norm=1.0)


def _trainers(consumers_j, consumers_t, loss_wrap=lambda f: f, steps=STEPS,
              lr=1e-3, arch=ARCH):
    jspec = jreg.get(arch)
    jcfg = jspec.smoke()
    spec = registry.get(arch)
    cfg = spec.smoke()
    jparams = _np_params(arch=arch)
    dcfg = dict(vocab=cfg.vocab, seq=S, global_batch=B, seed=1)
    jt = jtrainer.Trainer(
        loss_wrap(jreg.make_loss_fn_v2(jspec, jcfg)), jparams, JPexSpec(),
        jadamw.AdamWConfig(lr=lr,
                           schedule=jsched.linear_warmup_cosine(3, steps)),
        jtrainer.TrainConfig(consumers=consumers_j, steps=steps,
                             log_every=0),
        jpipe.DataConfig(**dcfg))
    tt = ttrainer.Trainer(
        loss_wrap(registry.make_loss_fn_v2(spec, cfg)),
        interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        PexSpec(),
        adamw.AdamWConfig(lr=lr,
                          schedule=tsched.linear_warmup_cosine(3, steps)),
        ttrainer.TrainConfig(consumers=consumers_t, steps=steps,
                             log_every=0),
        tpipe.DataConfig(**dcfg), device="cpu")
    return jt, tt


@pytest.mark.parametrize("mode", MODES)
def test_trainer_loss_curve_matches_reference(mode):
    jt, tt = _trainers(_consumers(mode, False), _consumers(mode, True))
    jm, tm = jt.train(), tt.train()
    assert len(tm) == STEPS
    for j, t in zip(jm, tm):
        assert sorted(t) == sorted(j)
        for k in ("loss", "norm_mean", "norm_max", "gns"):
            if k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                           err_msg=f"step {t['step']} {k}")


def test_trainer_gemma2_clip_curve_matches_reference():
    """gemma2-9b's smoke config (S=16 reaches past its window of 8) under
    the clip mode: 10 steps beside the reference's ``Trainer``."""
    jt, tt = _trainers(_consumers("clip", False), _consumers("clip", True),
                       arch="gemma2-9b")
    jm, tm = jt.train(), tt.train()
    assert len(tm) == STEPS
    for j, t in zip(jm, tm):
        assert sorted(t) == sorted(j)
        for k in ("loss", "norm_mean", "norm_max"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"step {t['step']} {k}")


def _poisoned(loss_fn):
    def poisoned(params, batch, tap):
        inner = {k: v for k, v in batch.items() if k != "poison"}
        loss_vec, aux = loss_fn(params, inner, tap)
        return loss_vec * batch["poison"], aux
    return poisoned


def test_trainer_quarantine_matches_reference():
    """A loss that is NaN for examples 2 and 5: both trainers record the
    same quarantine event, log the same metrics and keep finite
    parameters; a batch poisoned everywhere skips the step."""
    cons = (jplan.Norms(), jplan.Clip(1.0))
    jt, tt = _trainers(cons, (tplan.Norms(), tplan.Clip(1.0)),
                       loss_wrap=_poisoned, steps=2)
    poison = np.ones(B, np.float32)
    poison[[2, 5]] = np.nan
    jb = dict(jt.data.batch_at(0), poison=jnp.asarray(poison))
    tb = dict(tt.data.batch_at(0), poison=torch.from_numpy(poison))
    jm, tm = jt.run_step(jb), tt.run_step(tb)
    assert tt.events == jt.events == [{"step": 0, "kind": "quarantine",
                                       "examples": [2, 5]}]
    assert tm["quarantined"] == jm["quarantined"] == 2
    for k in ("loss", "norm_mean", "norm_max"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4)
    got = _leaves(interop.params_to_numpy(tt.params))
    for g, w in zip(got, _leaves(jt.params)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    before = _leaves(interop.params_to_numpy(tt.params))
    tb["poison"] = torch.full((B,), float("nan"))
    m = tt.run_step(tb)
    assert m["skipped"] == 1 and tt.events[-1]["kind"] == "skip_step"
    for g, w in zip(_leaves(interop.params_to_numpy(tt.params)), before):
        np.testing.assert_array_equal(g, w)


def _port_trainer(consumers, **kw):
    spec = registry.get(ARCH)
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    return ttrainer.Trainer(
        registry.make_loss_fn_v2(spec, cfg), params, PexSpec(),
        adamw.AdamWConfig(lr=1e-3),
        ttrainer.TrainConfig(consumers=consumers, steps=3, log_every=0,
                             **kw),
        tpipe.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B),
        device="cpu")


def test_trainer_refuses_a_plan_without_a_gradient():
    with pytest.raises(ValueError, match="gradient-producing"):
        _port_trainer((tplan.Norms(),))


def test_trainer_meshes_and_checkpoints(tmp_path):
    """A one-rank mesh trains bit for bit as the local trainer does, and
    ``rebind_mesh`` moves a trainer on and off it
    (``tests/test_torch_dist_train.py`` holds two ranks to the reference).
    Both checkpoint: the local trainer every step (``keep`` 3), the meshed
    one, whose first rank writes, at its last; each restores its last
    step's state bit for bit, the meshed one onto the mesh
    (``shardings=``), and the two step-3 shards hold the same bytes."""
    cons = ttrainer.consumers_for_mode("clip", B, noise_std=0.5)
    local = _port_trainer(cons, ckpt_dir=str(tmp_path / "local"),
                          ckpt_every=1)
    local.train()
    assert local.ckpt.all_steps() == [1, 2, 3]
    with tdp.one_rank(tmp_path):
        mesh = make_host_mesh(device_type="cpu")
        spec = registry.get(ARCH)
        cfg = spec.smoke()
        params = registry.family_module(spec).init(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        meshed = ttrainer.Trainer(
            registry.make_loss_fn_v2(spec, cfg), params, PexSpec(),
            adamw.AdamWConfig(lr=1e-3),
            ttrainer.TrainConfig(consumers=cons, steps=3, log_every=0,
                                 ckpt_every=3,
                                 ckpt_dir=str(tmp_path / "mesh")),
            tpipe.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B),
            mesh=mesh, device="cpu")
        assert meshed.engine.mesh is mesh
        meshed.train()
        meshed.rebind_mesh(None)
        assert meshed.engine.mesh is None
        meshed.rebind_mesh(mesh, data_axes=("data",))
        assert meshed.engine.mesh is mesh
        trained = [x.clone() for x in tree_leaves(meshed._state_tree())]
        assert meshed.restore_from(
            shardings=shd.sharding_for((), mesh)) == 3
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(meshed._state_tree()), trained))
        assert meshed.opt_state.step == 3
    for a, b in zip(tree_leaves(local.params), tree_leaves(meshed.params)):
        assert torch.equal(a, b)
    assert [m["loss"] for m in local.metrics] == \
        [m["loss"] for m in meshed.metrics]
    trained = [x.clone() for x in tree_leaves(local._state_tree())]
    assert local.restore_from() == 3 and local.opt_state.step == 3
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(local._state_tree()), trained))
    shard = "step_000000003/shard_00000.npz"
    assert (tmp_path / "local" / shard).read_bytes() == \
        (tmp_path / "mesh" / shard).read_bytes()
    assert not hasattr(ttrainer, "WAITS")
    assert ttrainer.RESUME_EXTRA_KEYS == jtrainer.RESUME_EXTRA_KEYS


def test_trainer_generators_are_stable_per_seed():
    """Noise and Importance slots left at rng=None get child generators
    from the trainer's seed: the same seed replays the same run, another
    seed does not."""
    def run(seed):
        t = _port_trainer((tplan.Importance(4), tplan.Clip(1.0),
                           tplan.Noise(0.5)), seed=seed)
        return [m["loss"] for m in t.train()], t.params["head"]["w"]
    (l0, w0), (l1, w1), (l2, w2) = run(0), run(0), run(1)
    assert l0 == l1 and torch.equal(w0, w1)
    assert not torch.equal(w0, w2)
    assert all(math.isfinite(x) for x in l0 + l2)


def test_trainer_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    spec = registry.get(ARCH)
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(registry.make_loss_fn_v2(spec, cfg), params,
                         PexSpec(), adamw.AdamWConfig(),
                         ttrainer.TrainConfig(), tpipe.DataConfig(
                             vocab=cfg.vocab, seq=S, global_batch=B))


@pytest.mark.parametrize("mode", ["plain", "norms", "clip", "importance"])
def test_launcher_runs_each_mode_on_cpu(mode, capsys):
    ms = tlaunch.main(["--arch", ARCH, "--smoke", "--mode", mode,
                       "--steps", "2", "--batch", "8", "--seq", "16",
                       "--noise-std", "0.1", "--device", "cpu"])
    assert len(ms) == 2 and all(math.isfinite(m["loss"]) for m in ms)
    assert f"mode={mode}, device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-7b", "minitron-4b", "gemma2-9b",
                                  "qwen2-vl-7b", "deepseek-v2-236b"])
def test_launcher_runs_each_arch_on_cpu(arch, capsys):
    """qwen2-vl trains on ``SyntheticLM``'s ids and labels alone: the
    text-only M-RoPE fallback, as in the reference."""
    ms = tlaunch.main(["--arch", arch, "--smoke", "--mode", "clip",
                       "--steps", "2", "--batch", "4", "--seq", "24",
                       "--device", "cpu"])
    assert len(ms) == 2 and all(math.isfinite(m["loss"]) for m in ms)
    assert f"{arch}: " in capsys.readouterr().out


LAUNCH = ["--arch", ARCH, "--smoke", "--mode", "clip", "--batch", "4",
          "--seq", "16", "--device", "cpu"]


@pytest.fixture
def one_thread():
    """One intra-op thread for the smoke runs (as a spawned rank has): many
    threads a worker only contend under a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", [["--data-parallel", "--ckpt-dir", "ck"],
                                  ["--ckpt-dir", "ck"], ["--resume"]])
def test_launcher_checkpoints_and_resumes(flag, tmp_path, one_thread):
    """``--ckpt-dir`` saves every ``ckpt_every`` (50) steps, as the
    reference's launcher does: a 52-step run leaves step 50 (with
    ``--data-parallel`` its one spawned gloo rank writes it). ``--resume``
    on one process then trains steps 50 and 51 from it, and their losses
    are the first run's, bit for bit (clip with no noise draws nothing; the
    schedule spans the same 52 steps). Without a checkpoint, ``--resume``
    trains from step 0."""
    ck = str(tmp_path / "ck")
    flag = [ck if f == "ck" else f for f in flag]
    if flag == ["--resume"]:
        ms = tlaunch.main(LAUNCH + ["--steps", "2", "--resume",
                                    "--ckpt-dir", ck])
        assert [m["step"] for m in ms] == [0, 1] and not os.listdir(ck)
        flag = ["--ckpt-dir", ck]
    first = tlaunch.main(LAUNCH + ["--steps", "52"] + flag)
    assert len(first) == 52
    assert sorted(os.listdir(ck)) == ["step_000000050"]
    with open(os.path.join(ck, "step_000000050", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["extra"] == {"step": 50, "opt_step": 50, "seed": 0,
                                 "data": {"step": 50, "seed": 0}}
    resumed = tlaunch.main(LAUNCH + ["--steps", "52", "--resume",
                                     "--ckpt-dir", ck])
    assert [m["step"] for m in resumed] == [50, 51]
    assert [m["loss"] for m in resumed] == \
        [m["loss"] for m in first[50:]]
