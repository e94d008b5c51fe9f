"""The port's model-axis sharding (``nn.param.axes_of``,
``configs.common.base_rules``, ``models.registry.rules_for``,
``dist.sharding``'s DTensor layer, the sharded ``Engine`` step, sharded
checkpoints and ``launch.dryrun``'s sharded mode) against the JAX
reference's.

- Axes: every leaf of the ten archs' smoke ``init`` (and of a LoRA-fied
  llama3.2-1b) carries the reference's logical axes, the reference's layer
  axes dropped.
- Specs and bytes: for each arch at its published config, each ``SHAPES``
  entry and both production meshes, ``rules_for`` and every leaf's
  resolved spec equal the reference's, and the analytic per-device bytes
  of the parameters and of AdamW's moments equal the reference's
  ``_tree_bytes_per_dev`` (over a device-free ``AbstractMesh``; the
  reference's state also holds a 4-byte step counter, which the port's
  AdamW keeps on the host).
- The sharded step: four gloo ranks on a (data=2, model=2) mesh run
  ``Engine().step`` on DTensor parameters of llama3.2-1b (GQA) and
  phi3.5-moe (experts over the model axis, two dispatch groups, one a
  data rank) with ``[Norms, Grads]`` and ``[Norms, Clip(1.0), Grads]``:
  loss, norms and gradients against the reference's unsharded jitted step
  on the same numpy inputs at 1e-4 relative (f32), each gradient in its
  parameter's placements.
- Token granularity and Importance: ``[Clip(1.0, granularity="token"),
  Grads]`` of both archs (the (B, S) map and the token-weighted
  gradients), a token ``Engine``'s ``[Norms]``, and llama3.2-1b's
  ``[Norms, Importance(3), Grads]`` with the reference's indices injected
  (3 rows over the 2-way data axis: the sub-batch replicated), each against
  the reference's unsharded jitted step.
- Noise and AdamW: a sharded ``[Clip, Noise]`` step adds the unsharded
  step's noise (the whole draw's shard), and AdamW on DTensor parameters
  updates them as it updates the plain ones.
- Restore: a checkpoint saved by this process restores onto ``Shard``
  placements bit for bit on every rank, and a sharded tree saved by the
  ranks restores here, and in the reference's manager, bit for bit.
- Dry-run: ``launch.dryrun``'s sharded mode on the (4, 4) smoke mesh
  records llama3.2-1b's train, prefill and decode cells and zamba2's
  train cell, each train cell's per-device parameter and state bytes
  equal to the analytic figures.
- Probes and perf: ``launch.probes``' sharded default on llama3.2-1b's
  smoke_train cell extrapolates to the 4-layer full sharded record in
  flops, bytes and each collective's bytes (1e-6 relative), reads the
  peak from the dry-run's 4x4 cell and carries the reference's keys;
  ``launch.perf``'s ``no_remat`` runs on the sharded record.
- Refusals: ``Engine(mesh=)`` (``dist.pex``) and the selfcheck's checks
  refuse a model axis of extent 2, as the reference's do.

The ranks and the dry-run (``launch.dryrun``'s smoke cells, then the
probes and the perf variant, in a process of their own) start when the
module does (``_group``) and run while the other tests run in this
process; neither imports JAX.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_dist_parity as tdp
from repro_torch import interop, pex
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.nn import param as pm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = sorted(registry.ARCHS)
B, S = 4, 8
MESH = ((2, 2), ("data", "model"))
STEP_RTOL = 1e-4
STEPS = {"llama3.2-1b": None, "phi3.5-moe": 2}   # dispatch groups
CONSUMERS = {"norms_grads": lambda: [pex.Norms(), pex.Grads()],
             "clip": lambda: [pex.Norms(), pex.Clip(1.0), pex.Grads()],
             "token_clip": lambda: [pex.Clip(1.0, granularity="token"),
                                    pex.Grads()]}
#: the Importance case (llama3.2-1b): k rows the 2-way data axis does not
#: divide, drawn with the reference's key
IMP_K, IMP_KEY = 3, 7


def _edit(groups):
    def edit(cfg):
        if groups is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=groups))
    return edit


def _rules(spec, cfg):
    return registry.rules_for(spec, cfg, ShapeSpec("t", "train", S, B),
                              False, model_size=2, data_size=2)


#: the dry-run's subprocess: its smoke cells of llama3.2-1b and zamba2-7b
#: on (4, 4); then, on the sharded record of llama3.2-1b's smoke_train
#: cell, ``launch.probes`` at the smoke depth (the peak read from the
#: dry-run's 4x4 cell) and at 4 layers with the full record beside it,
#: and ``launch.perf``'s ``no_remat`` at 4 layers
PROBE_LAYERS = 4
DRY_SCRIPT = f"""
import dataclasses, sys
from repro_torch.launch import dryrun, perf, probes
from repro_torch.models import registry
dryrun.main(["--smoke", "--arch", "llama3.2-1b", "--arch", "zamba2-7b",
             "--out", sys.argv[1]])
probes.main(["--smoke", "--arch", "llama3.2-1b", "--shape", "smoke_train",
             "--tag", "cell", "--out", sys.argv[2], "--dryrun-dir",
             sys.argv[1]])
cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke(),
                          n_layers={PROBE_LAYERS})
probes.run_probes("llama3.2-1b", "smoke_train", smoke=True, cfg=cfg,
                  full_record=True, out_dir=sys.argv[2])
perf.run_variant("llama3.2-1b", "smoke_train", "no_remat", smoke=True,
                 cfg=cfg, out_dir=sys.argv[2])
"""


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------

def sharded_ranks(rank, world, path):
    """Every job of the spawned group on one rank, on the case pickled at
    ``path`` (a spawned process reads its arguments through a pipe before
    it starts, so they are kept small); results as numpy (the
    reference's layout)."""
    with open(path, "rb") as f:
        case = pickle.load(f)
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import selfcheck
    mesh = shd.make_mesh(*MESH, device_type="cpu")
    out = {"steps": {}, "placements_ok": True}
    for arch, st in case["steps"].items():
        spec = registry.get(arch)
        cfg = _edit(STEPS[arch])(spec.smoke())
        mod = registry.family_module(spec)
        params = interop.params_from_numpy(st["params"], device="cpu")
        axes = pm.param_axes(mod.init, cfg)
        batch = {k: torch.as_tensor(v) for k, v in st["batch"].items()}
        loss = registry.make_loss_fn_v2(spec, cfg)
        for name, cons in CONSUMERS.items():
            with shd.use_rules(mesh, _rules(spec, cfg)):
                dp = shd.distribute_tree(params, axes)
                r = pex.Engine().step(loss, dp, batch, cons())
            grads = pm.tree_leaves(r.grads)
            out["placements_ok"] &= all(
                tuple(g.placements) == tuple(p.placements)
                for g, p in zip(grads, pm.tree_leaves(dp)))
            full = pm.tree_unflatten(pm.tree_flatten(r.grads)[1],
                                     [g.full_tensor() for g in grads])
            out["steps"][arch, name] = {
                "loss_vec": r.loss_vec.numpy(), "sq_norms": r.sq_norms.numpy(),
                "grads": tdp.np_tree(full)}
        if arch == "llama3.2-1b":
            out["noise_adamw"] = _noise_and_adamw(mesh, spec, cfg, params,
                                                  axes, batch, loss)
            out["token_norms"], out["importance"] = _token_and_importance(
                mesh, spec, cfg, params, axes, batch, loss, case["imp"])
    # restore onto Shard placements, and save a sharded tree
    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    mod = registry.family_module(spec)
    like = mod.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    axes = pm.axes_of(like)
    with shd.use_rules(mesh, _rules(spec, cfg)):
        got, _ = CheckpointManager(case["ckpt"]).restore(
            0, like, shardings=shd.sharding_tree(axes))
        saved = torch.load(case["saved"])
        shards, bits = 0, True
        for x, want in zip(pm.tree_leaves(got), saved):
            if shd.is_dtensor(x):
                shards += 1
                piece = distribute_tensor(want, mesh, x.placements,
                                          src_data_rank=None).to_local()
                bits &= torch.equal(x.to_local(), piece)
                bits &= torch.equal(x.full_tensor(), want)
            else:
                bits &= torch.equal(x, want)
        CheckpointManager(case["ckpt2"]).save(3, got, block=True)
    out["restore"] = {"shards": shards, "bits": bool(bits)}
    # refusals: the data-parallel pipeline and the selfcheck's checks
    aspec = registry.get("llama3.2-1b")
    cfg = aspec.smoke()
    params = registry.family_module(aspec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(aspec, cfg, ShapeSpec("t", "train",
                                                            S, B),
                                      device="cpu")
    out["pex"] = tdp._raised(lambda: pex.Engine(mesh=mesh).step(
        registry.make_loss_fn_v2(aspec, cfg), params, batch,
        [pex.Norms()]))
    out["selfcheck"] = tdp._raised(lambda: selfcheck._checks(
        rank, torch.device("cpu"), "gloo", [], arch="llama3.2-1b", batch=8,
        seq=8, model_parallel=2, method="gram"))
    return out


def _noise_and_adamw(mesh, spec, cfg, params, axes, batch, loss):
    """A sharded ``[Clip, Noise]`` step against the unsharded one from the
    same generator seed (the noise is the whole draw's shard), then one
    AdamW update of the sharded parameters against the update of the
    plain ones on the same gradients: the largest |Δ| of each, relative
    to the largest |value|."""
    from repro_torch.optim import adamw

    def cons():
        return [pex.Clip(1.0), pex.Noise(0.5, torch.Generator()
                                         .manual_seed(11))]
    want = pex.Engine().step(loss, params, batch, cons())
    with shd.use_rules(mesh, _rules(spec, cfg)):
        dp = shd.distribute_tree(params, axes)
        got = pex.Engine().step(loss, dp, batch, cons())
        noise = max(float((g.full_tensor() - w).abs().max()
                          / w.abs().max())
                    for g, w in zip(pm.tree_leaves(got.grads),
                                    pm.tree_leaves(want.grads)))
        plain = pm.tree_map(lambda x: x.clone(), params)
        adamw.update(adamw.AdamWConfig(), adamw.init(plain), plain,
                     want.grads)
        sharded_grads = pm.tree_unflatten(
            pm.tree_flatten(want.grads)[1],
            [shd.like(x, g) for x, g in zip(pm.tree_leaves(dp),
                                            pm.tree_leaves(want.grads))])
        adamw.update(adamw.AdamWConfig(), adamw.init(dp), dp,
                     sharded_grads)
        update = max(float((x.full_tensor() - w).abs().max()
                           / w.abs().max())
                     for x, w in zip(pm.tree_leaves(dp),
                                     pm.tree_leaves(plain)))
    return {"noise": noise, "adamw": update}


def _token_and_importance(mesh, spec, cfg, params, axes, batch, loss,
                          indices_path):
    """A token-granularity ``Engine`` ``[Norms]`` step on the DTensor
    parameters (its (B, S) map), and ``[Norms, Importance(IMP_K),
    Grads]`` with the reference's indices injected at the draw site (the
    parent writes them to ``indices_path`` once its reference step has
    drawn them)."""
    from repro_torch.core import importance as timp
    with shd.use_rules(mesh, _rules(spec, cfg)):
        dp = shd.distribute_tree(params, axes)
        tok = pex.Engine(granularity="token").step(loss, dp, batch,
                                                   [pex.Norms()])
        for _ in range(600):
            if os.path.exists(indices_path):
                break
            time.sleep(0.5)
        idx = torch.from_numpy(np.load(indices_path))
        choice = timp._choice
        timp._choice = lambda gen, p, k, replace: idx
        try:
            r = pex.Engine().step(loss, dp, batch, [
                pex.Norms(), pex.Importance(IMP_K, rng=torch.Generator()),
                pex.Grads()])
        finally:
            timp._choice = choice
    full = pm.tree_unflatten(pm.tree_flatten(r.grads)[1],
                             [g.full_tensor() for g in
                              pm.tree_leaves(r.grads)])
    return tok.sq_norms.numpy(), {
        "indices": r.sample.indices.numpy(), "loss_vec": r.loss_vec.numpy(),
        "sq_norms": r.sq_norms.numpy(),
        "sample_weights": r.sample.weights.numpy(),
        "weights": r.weights.numpy(), "grads": tdp.np_tree(full),
        "placements_ok": all(tuple(g.placements) == tuple(p.placements)
                             for g, p in zip(pm.tree_leaves(r.grads),
                                             pm.tree_leaves(dp)))}


def _ref_importance(steps, path):
    """The reference's unsharded jitted ``[Norms, Importance(IMP_K),
    Grads]`` step of llama3.2-1b on the ranks' inputs; its indices written
    to ``path`` for the ranks."""
    import jax
    import jax.numpy as jnp
    from repro import pex as jpex
    from repro.models import registry as jreg
    jspec = jreg.get("llama3.2-1b")
    jcfg = jspec.smoke()
    case = steps["llama3.2-1b"]
    jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])
    jbatch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    jloss = jreg.make_loss_fn_v2(jspec, jcfg)
    eng = jpex.Engine(jpex.PexSpec())
    cons = [jpex.Norms(), jpex.Importance(IMP_K, rng=jax.random.PRNGKey(
        IMP_KEY)), jpex.Grads()]
    j = jax.jit(lambda p, b: eng.step(jloss, p, b, cons))(jparams, jbatch)
    np.save(path + ".tmp.npy", np.asarray(j.sample.indices))
    os.replace(path + ".tmp.npy", path)
    return j


@pytest.fixture(scope="module", autouse=True)
def _group(tmp_path_factory):
    """The port's smoke parameters (seed 0) and batches (numpy seed 3) of
    each stepped arch as numpy, a checkpoint of the port's llama3.2-1b
    init, and the ranks and the dry-run started on them; the fixture's
    value waits for their results."""
    tmp = tmp_path_factory.mktemp("sharding")
    steps = {}
    for arch, groups in STEPS.items():
        spec = registry.get(arch)
        cfg = _edit(groups)(spec.smoke())
        params = registry.family_module(spec).init(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = registry.make_train_batch(spec, cfg, ShapeSpec(
            "t", "train", S, B), 3, device="cpu")
        steps[arch] = {"params": interop.params_to_numpy(params),
                       "batch": {k: v.numpy() for k, v in batch.items()}}
    spec = registry.get("llama3.2-1b")
    like = registry.family_module(spec).init(
        spec.smoke(), torch.Generator().manual_seed(0), device="cpu")
    CheckpointManager(str(tmp / "ckpt")).save(0, like, block=True)
    torch.save([x.clone() for x in pm.tree_leaves(like)], tmp / "saved.pt")
    case = {"steps": steps, "ckpt": str(tmp / "ckpt"),
            "ckpt2": str(tmp / "ckpt2"), "saved": str(tmp / "saved.pt"),
            "imp": str(tmp / "indices.npy")}
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    wait = tdp.start(tmp, 4, sharded_ranks, str(tmp / "case.pkl"))
    # the dry-run's smoke cells, then the sharded probes and a perf
    # variant on the smoke mesh, in a process of their own meanwhile
    dry = subprocess.Popen(
        [sys.executable, "-c", DRY_SCRIPT, str(tmp / "dryrun"),
         str(tmp / "roofline")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))
    got = {"imp_ref": _ref_importance(steps, case["imp"])}

    def results():
        if "ranks" not in got:
            got["ranks"] = wait()
            got["dryrun"] = (dry.wait(timeout=300), dry.stdout.read(),
                             str(tmp / "dryrun"))
        return got["ranks"], steps, like, case, got["dryrun"]
    results.steps = steps       # what the ranks run on, without waiting
    results.imp_ref = got["imp_ref"]
    results.roofline = str(tmp / "roofline")
    yield results
    results()


# ---------------------------------------------------------------------------
# 1. axes
# ---------------------------------------------------------------------------

def _ref_axes(arch, cfg_edit=lambda c: c):
    import jax
    from repro.models import registry as jreg
    from repro.nn.param import axes_of
    spec = jreg.get(arch)
    cfg = cfg_edit(spec.smoke())
    boxed = jax.eval_shape(lambda k: jreg.family_module(spec).init(k, cfg),
                           jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        axes_of(boxed), is_leaf=pm.is_axes)
    return {tuple(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k))) for k in path): ax for path, ax in flat}


def _normal(path, axes, zamba):
    """A port leaf's (path, axes) in the reference's stacked form: the
    layer indices after a stacked key dropped, as the reference's layer
    axes are."""
    path = list(path)
    if path and path[0] in interop.STACKS:
        depth = 2 if zamba and path[0] == "blocks" else 1
        del path[1:1 + depth]
        axes = (None,) * depth + tuple(axes)
    return tuple(path), tuple(axes)


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b+lora"])
def test_axes_match_reference(arch):
    from repro.nn.lora import LoraCfg as JLoraCfg
    from repro_torch.nn.lora import LoraCfg
    name = arch.split("+")[0]
    spec = registry.get(name)
    cfg = spec.smoke()
    jedit = lambda c: c
    if arch.endswith("+lora"):
        cfg = dataclasses.replace(cfg, lora=LoraCfg(rank=4))
        jedit = lambda c: dataclasses.replace(c, lora=JLoraCfg(rank=4))
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator().manual_seed(0), device="meta")
    axes = pm.axes_leaves(pm.axes_of(params))
    want = _ref_axes(name, jedit)
    got = {}
    for path, ax in zip(pm.tree_paths(params), axes):
        p, a = _normal(path, ax, spec.family == "zamba2")
        assert got.setdefault(p, a) == a, p      # every layer alike
    assert got == want


# ---------------------------------------------------------------------------
# 2. specs and bytes
# ---------------------------------------------------------------------------

def _ref_bytes():
    """The reference's ``_tree_bytes_per_dev``, imported without letting
    its module's device-count flag reach an uninitialized JAX."""
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jdry._tree_bytes_per_dev


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_and_bytes_match_reference(arch):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.dist import sharding as jshd
    from repro.models import registry as jreg
    from repro.nn.param import axes_of, unbox
    tree_bytes = _ref_bytes()
    jspec, spec = jreg.get(arch), registry.get(arch)
    jcfg, cfg = jspec.full(), spec.full()
    boxed = jax.eval_shape(lambda k: jreg.family_module(jspec).init(k, jcfg),
                           jax.random.key(0))
    jaxes, sds = axes_of(boxed), unbox(boxed)
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="meta")
    leaves = pm.tree_leaves(params)
    axes = pm.axes_leaves(pm.axes_of(params))
    zamba = spec.family == "zamba2"
    by_path = dict(_normal(p, a, zamba)
                   for p, a in zip(pm.tree_paths(params), axes))
    assert sorted(by_path) == sorted(_ref_axes(arch))
    for shape in SHAPES.values():
        for multi in (False, True):
            rules = registry.rules_for(spec, cfg, shape, multi)
            assert rules == jreg.rules_for(jspec, jcfg, shape, multi)
            with jshd.use_rules(None, rules), shd.use_rules(None, rules):
                for p, a in by_path.items():
                    assert shd.spec(*a) == tuple(jshd.spec(*a)), p
                sh = jax.tree_util.tree_map(
                    lambda ax: jshd.spec(*ax), jaxes, is_leaf=pm.is_axes)
            names = ("pod", "data", "model") if multi else ("data", "model")
            ext = (2, 16, 16) if multi else (16, 16)
            amesh = AbstractMesh(ext, names)
            sh = jax.tree_util.tree_map(
                lambda s: NamedSharding(amesh, s), sh,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want_p = tree_bytes(sds, sh, amesh)
            f32 = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), sds)
            want_s = 2 * tree_bytes(f32, sh, amesh)
            extents = dict(zip(names, ext))
            got_p = dryrun.tree_bytes_per_dev(leaves, axes, rules, extents)
            got_s = 2 * dryrun.tree_bytes_per_dev(leaves, axes, rules,
                                                  extents,
                                                  dtype=torch.float32)
            assert got_p == pytest.approx(want_p, rel=1e-12)
            assert got_s == pytest.approx(want_s, rel=1e-12)


# ---------------------------------------------------------------------------
# 3, 4, 6: the ranks' results
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _refs(_group):
    """The reference's unsharded jitted ``Engine.step`` of every case on
    the numpy inputs the ranks run on, all computed before the first wait
    for the ranks."""
    import jax
    import jax.numpy as jnp
    from repro import pex as jpex
    from repro.configs.common import ShapeSpec as JShape
    from repro.models import registry as jreg
    out = {}
    for arch, case in _group.steps.items():
        jspec = jreg.get(arch)
        jcfg = _edit(STEPS[arch])(jspec.smoke())
        jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])
        jbatch = jreg.make_train_batch(jspec, jcfg,
                                       JShape("t", "train", S, B), 3)
        for k, v in case["batch"].items():   # the same numpy draws
            np.testing.assert_array_equal(np.asarray(jbatch[k]), v)
        jloss = jreg.make_loss_fn_v2(jspec, jcfg)
        for name, jcons in {
                "norms_grads": [jpex.Norms(), jpex.Grads()],
                "clip": [jpex.Norms(), jpex.Clip(1.0), jpex.Grads()],
                "token_clip": [jpex.Clip(1.0, granularity="token"),
                               jpex.Grads()]}.items():
            eng = jpex.Engine(jpex.PexSpec())
            out[arch, name] = jax.jit(
                lambda p, b: eng.step(jloss, p, b, jcons))(jparams, jbatch)
    return out


@pytest.mark.parametrize("cons", sorted(CONSUMERS))
@pytest.mark.parametrize("arch", sorted(STEPS))
def test_sharded_step_matches_reference_unsharded(_group, _refs, arch,
                                                  cons):
    from torch_family_parity import close, close_trees
    j = _refs[arch, cons]
    ranks = _group()[0]
    got = ranks[0]["steps"][arch, cons]
    close(torch.from_numpy(got["loss_vec"]), j.loss_vec, STEP_RTOL)
    close(torch.from_numpy(got["sq_norms"]), j.sq_norms, STEP_RTOL)
    close_trees(interop.params_from_numpy(got["grads"], device="cpu"),
                j.grads, STEP_RTOL)
    for r in ranks[1:]:      # every rank holds the whole results
        np.testing.assert_array_equal(r["steps"][arch, cons]["sq_norms"],
                                      got["sq_norms"])
    assert all(r["placements_ok"] for r in ranks)


def test_sharded_token_granularity_no_longer_raises(_group, _refs):
    """``Engine(granularity="token")`` on DTensor parameters steps (the
    port refused it until the token accumulator took sharded operands):
    its (B, S) map is the reference's."""
    from torch_family_parity import close
    for r in _group()[0]:
        assert r["token_norms"].shape == (B, S)
        close(torch.from_numpy(r["token_norms"]),
              _refs["llama3.2-1b", "token_clip"].sq_norms, STEP_RTOL)


def test_sharded_importance_matches_reference_unsharded(_group):
    """``[Norms, Importance(3), Grads]`` on DTensor parameters with the
    reference's indices injected: 3 sampled rows do not split over the
    2-way data axis, so the sub-batch runs replicated; the loss vector,
    the pool's norms, the weights and the gradients are the reference's
    unsharded jitted step's."""
    from torch_family_parity import close, close_trees
    j = _group.imp_ref
    ranks = _group()[0]
    for r in ranks:
        got = r["importance"]
        np.testing.assert_array_equal(got["indices"],
                                      np.asarray(j.sample.indices))
        for key, want in (("loss_vec", j.loss_vec), ("sq_norms", j.sq_norms),
                          ("sample_weights", j.sample.weights),
                          ("weights", j.weights)):
            close(torch.from_numpy(got[key]), want, STEP_RTOL)
        close_trees(interop.params_from_numpy(got["grads"], device="cpu"),
                    j.grads, STEP_RTOL)
        assert got["placements_ok"]


def test_sharded_step_rules_reach_other_threads():
    """A CUDA backward (and a checkpointed block's recompute in it) runs
    on autograd's device thread: inside a ``sharded_step`` a thread with
    no rules of its own reads the ones active where the step began, and
    the step's own (mesh, batch dims) are unchanged."""
    import threading
    seen = {}

    def read():
        seen["rules"] = shd.current_rules()
    rules = {"batch": "data", "heads": "model"}
    with shd.use_rules("mesh", rules), shd.sharded_step("mesh", (0,)):
        t = threading.Thread(target=read)
        t.start()
        t.join(timeout=10)
        assert shd.current_step() == ("mesh", (0,))
    assert not t.is_alive()
    assert seen["rules"] == ("mesh", rules)
    with shd.sharded_step("mesh", (0,)):       # outside any rules
        t = threading.Thread(target=read)
        t.start()
        t.join(timeout=10)
    assert seen["rules"] == (None, {})
    assert shd.current_rules() == (None, {})


def test_sharded_noise_and_adamw_match_unsharded(_group):
    """Noise drawn whole at ``passes._standard_normal`` and added shard by
    shard: the unsharded step's noised gradient; AdamW on local shards
    (the global norm summed once over the mesh): the unsharded update."""
    ranks = _group()[0]
    for r in ranks:
        assert r["noise_adamw"]["noise"] < 1e-5, r["noise_adamw"]
        assert r["noise_adamw"]["adamw"] < 1e-6, r["noise_adamw"]


def test_restore_onto_shard_placements_bit_for_bit(_group):
    from repro.ckpt.checkpoint import CheckpointManager as JManager
    ranks, _, like, case, _ = _group()
    for r in ranks:
        assert r["restore"]["bits"]
        assert r["restore"]["shards"] > 0
    # the sharded tree the ranks saved: whole leaves, in either package
    back, _ = CheckpointManager(case["ckpt2"]).restore(3, like)
    for x, want in zip(pm.tree_leaves(back), pm.tree_leaves(like)):
        assert torch.equal(x, want)
    import jax
    np_like = pm.tree_map(lambda x: x.numpy(), like)   # the port's layout
    jback, _ = JManager(case["ckpt2"]).restore(3, np_like)
    for x, want in zip(jax.tree_util.tree_leaves(jback),
                       pm.tree_leaves(np_like)):
        np.testing.assert_array_equal(np.asarray(x), want)


def test_model_axis_refused_by_dist_pex_and_selfcheck(_group):
    ranks, *_ = _group()
    for r in ranks:
        assert r["pex"] == "NotImplementedError"
        assert r["selfcheck"] == "NotImplementedError"


# ---------------------------------------------------------------------------
# 5. the dry-run's sharded mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-1b", "smoke_train"), ("llama3.2-1b", "smoke_prefill"),
    ("llama3.2-1b", "smoke_decode"), ("zamba2-7b", "smoke_train")])
def test_dryrun_sharded_smoke_cells(_group, arch, shape):
    *_, (rc, log, out) = _group()
    assert rc == 0, log[-3000:]
    with open(os.path.join(out, f"{arch}__{shape}__4x4.json")) as f:
        res = dryrun.CellResult(**json.load(f))
    assert res.ok and res.mode == "sharded" and res.mesh == "4x4"
    assert res.ranks == 16 and res.n_ops > 0
    # rank 0's rows: the batch over the data axis
    assert res.local_batch == dryrun.shape_spec(shape).batch // 4
    assert res.coll_counts.get("all-gather", 0) > 0
    assert res.peak_bytes_per_dev > 0 and res.fits
    if shape == "smoke_train":
        assert res.param_bytes_per_dev == res.param_bytes_analytic > 0
        assert res.state_bytes_per_dev == res.state_bytes_analytic \
            == 2 * res.param_bytes_analytic
        assert res.coll_bytes.get("all-reduce@model", 0) > 0
        # the collectives pass: the norms and losses summed over the model
        # axis, every gradient leaf reached by the other data ranks' rows
        assert res.collective_findings == []


def _roofline(_group, name):
    *_, (rc, log, _) = _group()
    assert rc == 0, log[-3000:]
    with open(os.path.join(_group.roofline, name + ".json")) as f:
        return json.load(f)


def test_sharded_probes_match_the_full_sharded_record(_group):
    """``launch.probes``' default: every probe the sharded program on the
    smoke mesh; its 1- and 2-layer extrapolation equals the 4-layer full
    sharded record in flops, bytes and every collective's bytes, by kind
    and by mesh axis, and the roofline is the record's over 16 devices."""
    from repro_torch.roofline.analysis import COLL_KEYS
    d = _roofline(_group, "llama3.2-1b__smoke_train")
    assert d["mode"] == "sharded" and d["mesh"] == "4x4" and d["chips"] == 16
    full = d["full_record"]
    assert set(full) == set(d["per_rank"])
    for k, v in full.items():
        assert d["per_rank"][k] == pytest.approx(v, rel=1e-6), k
    for k in ("coll_ar", "coll_ag", "coll_rs"):
        assert full[k] > 0, k
    assert full["all-reduce@model"] > 0
    assert d["flops"] == 16 * d["per_rank"]["flops"]
    assert d["coll_breakdown"] == {k: 16 * d["per_rank"][k]
                                   for k in COLL_KEYS}
    assert d["coll_by_axis"] == {k: 16 * v for k, v in d["per_rank"].items()
                                 if "@" in k}
    assert d["probe_s"] > 0 and d["full_s"] > 0


def test_sharded_probes_read_the_dry_run_cell_and_the_reference_keys(
        _group):
    """Without a full record the peak and the parameter count are the
    dry-run's sharded cell's; ``probe_metrics``' keys are the
    reference's."""
    import types

    from repro.roofline.analysis import probe_metrics as ref_metrics
    d = _roofline(_group, "llama3.2-1b__smoke_train__cell")
    *_, (_, _, out) = _group()
    with open(os.path.join(out, "llama3.2-1b__smoke_train__4x4.json")) as f:
        cell = json.load(f)
    assert d["peak_gb_per_dev"] == cell["peak_bytes_per_dev"] / 1e9 > 0
    want = ref_metrics(types.SimpleNamespace(flops=0.0, bytes_accessed=0.0,
                                             coll_bytes={}))
    assert {k for k in d["probes"][0] if "@" not in k} == set(want)
    assert set(d["coll_breakdown"]) == {k for k in want
                                        if k.startswith("coll_")
                                        and k != "coll_bytes"}


def test_perf_variant_on_the_sharded_record(_group):
    """``launch.perf``'s ``no_remat`` on the sharded record: fewer flops
    than the remat baseline at the same depth (no recompute)."""
    base = _roofline(_group, "llama3.2-1b__smoke_train")
    d = _roofline(_group, "llama3.2-1b__smoke_train__no_remat")
    assert d["mode"] == "sharded" and d["mesh"] == "4x4"
    assert 0 < d["flops"] < base["flops"]
