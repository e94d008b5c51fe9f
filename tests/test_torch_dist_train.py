"""The port's ``Trainer(mesh=)``, ``TenantService(mesh=)`` and the train
launcher's ``--data-parallel`` against the JAX reference's.

Two gloo ranks of one CPU host (``torch_dist_parity``) run:

- the llama3.2-1b smoke ``Trainer`` (f32, B=8, S=16) for 4 steps of clip +
  noise and of importance (k = 2), with the reference ``Trainer``'s draws
  injected at the port's two draw sites (``passes._standard_normal``,
  ``importance._choice``): each step's loss, ``norm_mean`` and
  ``norm_max`` against the reference's at 1e-4, and both ranks' parameters
  bit for bit equal;
- the same clip + noise run with the port's own draws and
  ``compress_grads``: both ranks' parameters and error buffers bit for bit
  equal;
- ``TenantService(mesh=)``: the ``shard_map`` variant of the reference's
  ``test_service_matches_per_tenant_oracle`` — 110 tenants of ragged 1–4
  examples against the reference's service with its per-tenant draws
  injected, at both granularities (rtol 1e-5, atol 1e-6) — and the port's
  own draws against its single-tenant oracle engines.

``--data-parallel --device cpu`` runs one spawned gloo rank and trains as
the local launcher does.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_parity as tdp
from repro.core.taps import PexSpec as JPexSpec
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.nn import lora as jlora
from repro.nn.linear import linear as jlinear
from repro.nn.param import unbox
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.tenancy import AdapterStore as JStore
from repro.tenancy import TenantService as JService
from repro.train import trainer as jtrainer
from repro_torch import interop
from repro_torch.launch import train as tlaunch
from repro_torch.nn.param import tree_leaves

ARCH = "llama3.2-1b"
B, S, STEPS, LR, NOISE = 8, 16, 4, 1e-3, 0.1
RTOL = 1e-4


def _reference_trainer(consumers, jparams):
    """The reference ``Trainer`` with its step keys and importance indices
    recorded from its jitted step."""
    jspec = jreg.get(ARCH)
    jt = jtrainer.Trainer(
        jreg.make_loss_fn_v2(jspec, jspec.smoke()), jparams, JPexSpec(),
        jadamw.AdamWConfig(lr=LR,
                           schedule=jsched.linear_warmup_cosine(3, STEPS)),
        jtrainer.TrainConfig(consumers=consumers, steps=STEPS, log_every=0),
        jpipe.DataConfig(vocab=jspec.smoke().vocab, seq=S, global_batch=B,
                         seed=1))
    keys, indices = [], []
    step_fn = jt._step_fn

    def recorded(params, opt_state, err, batch, rng, *lw):
        out = step_fn(params, opt_state, err, batch, rng, *lw)
        keys.append(rng)
        if out[3].sample is not None:
            indices.append(np.asarray(out[3].sample.indices))
        return out

    jt._step_fn = recorded
    return jt.train(), keys, indices


def _noise_draws(keys, jparams):
    """The reference's N(0, 1) noise samples of each step (its one Noise
    slot's key split over the leaves), carried into the port's leaf order:
    a stacked leaf's sample is split per layer as ``interop`` splits
    parameters."""
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    draws = []
    for sub in keys:
        (key,) = jax.random.split(sub, 1)
        ks = jax.random.split(key, len(leaves))
        tree = jax.tree_util.tree_unflatten(treedef, [
            np.asarray(jax.random.normal(k, x.shape, jnp.float32))
            for k, x in zip(ks, leaves)])
        draws += [t.numpy() for t in tree_leaves(
            interop.params_from_numpy(tree, device="cpu"))]
    return draws


# --- the tenant service's problem (tests/test_torch_tenancy.py's) ----------

def _jinit_fn(key):
    return {"site": jlora.init_pair(key, tdp.D, tdp.O, tdp.R, tdp.ALPHA,
                                    boxed=False, b_std=0.4)}


def _jloss_fn(adapters, data, tap):
    p = {"w": jnp.asarray(tdp.W_BASE), "lora": adapters["site"]}
    z = jlinear(p, data["x"], tap=tap, group="all")
    tok = tap.token_loss(jnp.sum(jnp.square(z - data["y"]), axis=-1))
    return jnp.sum(tok, axis=1), {}


def _mixed(n_tenants, max_per=4, seed=7):
    rs = np.random.RandomState(seed)
    tenants = rs.choice(np.arange(1000, 50_000), size=n_tenants,
                        replace=False)
    owner = np.concatenate(
        [np.full(rs.randint(1, max_per + 1), t) for t in tenants])
    rs.shuffle(owner)
    b = len(owner)
    x = rs.standard_normal((b, tdp.S_TOK, tdp.D)).astype(np.float32)
    y = rs.standard_normal((b, tdp.S_TOK, tdp.O)).astype(np.float32)
    return x, y, owner


def _reference_store(owner):
    """The reference's store with the batch's tenants admitted, and its
    rows of them."""
    jstore = JStore(_jinit_fn, capacity=128, key=jax.random.PRNGKey(7))
    tenants = np.unique(owner)
    for t in tenants:
        jstore.admit(int(t))
    return jstore, jax.tree_util.tree_map(np.asarray, jstore.gather(tenants))


def _reference_draws(rng, owner):
    """The reference's per-tenant N(0, 1) draws of a step keyed ``rng``,
    tenant-major, leaf-minor: ``normal(split(fold_in(rng, t), 2)[i])``."""
    draws = []
    for t in np.unique(owner):
        keys = jax.random.split(jax.random.fold_in(rng, int(t)), 2)
        draws += [np.asarray(jax.random.normal(k, shape, jnp.float32))
                  for k, shape in zip(keys, [(tdp.D, tdp.R),
                                             (tdp.R, tdp.O)])]
    return draws


def _reference_service(x, y, owner, granularity, rng):
    """The reference service's step: its outputs and the tenants' rows
    after it. Its own test holds its one-device ``shard_map`` variant to
    the same oracle as this local one (which, unlike the mesh variant,
    compiles once for both calls here)."""
    jstore, _ = _reference_store(owner)
    jsvc = JService(jstore, _jloss_fn, clip_norm=tdp.C, noise_std=tdp.SIGMA,
                    noise_scale=tdp.C, lr=tdp.LR, granularity=granularity)
    jres = jsvc.step({"x": jnp.asarray(x), "y": jnp.asarray(y)}, owner,
                     rng=rng)
    after = jstore.gather(np.unique(owner))["site"]
    return jres, (np.asarray(after.a), np.asarray(after.b))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jspec = jreg.get(ARCH)
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jspec.smoke()))
    clip_cons = jtrainer.consumers_for_mode("clip", B, clip_norm=1.0,
                                            noise_std=NOISE)
    ref_clip, keys, _ = _reference_trainer(clip_cons, jparams)
    ref_imp, _, indices = _reference_trainer(
        jtrainer.consumers_for_mode("importance", B), jparams)
    x, y, owner = _mixed(110)
    ox, oy, oowner = _mixed(24, seed=11)
    rng = jax.random.PRNGKey(99)
    trainer_case = {
        "arch": ARCH, "lr": LR, "steps": STEPS, "noise_std": NOISE,
        "params": jax.tree_util.tree_map(np.asarray, jparams),
        "data": dict(vocab=jspec.smoke().vocab, seq=S, global_batch=B,
                     seed=1),
        "noise": _noise_draws(keys, jparams), "indices": indices}
    tenant_case = {"x": x, "y": y, "owner": owner,
                   "rows": _reference_store(owner)[1],
                   "draws": _reference_draws(rng, owner),
                   "ox": ox, "oy": oy, "oowner": oowner}
    ranks = tdp.start(tmp_path_factory.mktemp("train2"), 2, tdp.jobs,
                      [("trainer", tdp.trainer_runs, trainer_case),
                       ("tenants", tdp.tenant_steps, tenant_case)])
    services = {g: _reference_service(x, y, owner, g, rng)
                for g in ("example", "token")}
    ranks = ranks()
    return {"clip_noise": ref_clip, "importance": ref_imp}, services, ranks


@pytest.mark.parametrize("run", ["clip_noise", "importance"])
def test_mesh_trainer_curve_matches_reference(world2, run):
    refs, _, ranks = world2
    got = ranks[0]["trainer"][run]
    assert got["left"] == [0, 0]        # every injected draw was taken
    assert len(got["metrics"]) == STEPS
    for j, t in zip(refs[run], got["metrics"]):
        for k in ("loss", "norm_mean", "norm_max"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL,
                                       err_msg=f"step {t['step']} {k}")


@pytest.mark.parametrize("run", ["clip_noise", "importance",
                                 "own_compress"])
def test_mesh_trainer_ranks_hold_bitwise_equal_parameters(world2, run):
    _, _, ranks = world2
    a, b = (r["trainer"][run] for r in ranks)
    assert a["metrics"] == b["metrics"]
    for x, y in zip(jax.tree_util.tree_leaves(a["params"]),
                    jax.tree_util.tree_leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
    assert all(math.isfinite(m["loss"]) for m in a["metrics"])


def test_mesh_trainer_compression_error_buffers_bitwise_equal(world2):
    _, _, ranks = world2
    a, b = (r["trainer"]["own_compress"]["err"] for r in ranks)
    leaves = jax.tree_util.tree_leaves(a)
    assert leaves and any(np.abs(x).max() > 0 for x in leaves)
    for x, y in zip(leaves, jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert ranks[0]["trainer"]["rebound_engine_mesh"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("granularity", ["example", "token"])
def test_mesh_service_matches_reference(world2, granularity):
    _, services, ranks = world2
    jres, (want_a, want_b) = services[granularity]
    for rank in ranks:
        got = rank["tenants"][granularity]
        assert got["left"] == 0
        np.testing.assert_array_equal(got["tenant_ids"], jres.tenant_ids)
        np.testing.assert_array_equal(got["tenant_count"],
                                      np.asarray(jres.tenant_count))
        for k in ("sq_norms", "clip_coef", "loss_vec", "tenant_loss"):
            _close(got[k], getattr(jres, k))
        if granularity == "example":
            _close(got["tenant_clip_mean"], jres.tenant_clip_mean)
            _close(got["tenant_clip_min"], jres.tenant_clip_min)
        _close(got["a"], want_a)
        _close(got["b"], want_b)
    for k in ("a", "b", "sq_norms"):
        np.testing.assert_array_equal(ranks[0]["tenants"][granularity][k],
                                      ranks[1]["tenants"][granularity][k])


def test_mesh_service_matches_single_tenant_engines(world2):
    _, _, ranks = world2
    pairs = ranks[0]["tenants"]["oracle"]
    assert len(pairs) == 4 * 24
    for got, want in pairs:
        _close(got, want)


def test_launcher_data_parallel_on_cpu(capfd):
    argv = ["--arch", ARCH, "--smoke", "--mode", "clip", "--steps", "2",
            "--batch", "8", "--seq", "16", "--noise-std", "0.1",
            "--device", "cpu"]
    local = tlaunch.main(argv)
    dp = tlaunch.main(argv + ["--data-parallel"])
    out = capfd.readouterr().out
    assert "data-parallel over 1 ranks (gloo, cpu)" in out
    assert [m["loss"] for m in dp] == [m["loss"] for m in local]
    assert [m["norm_mean"] for m in dp] == [m["norm_mean"] for m in local]
