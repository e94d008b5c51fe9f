"""The port's data-parallel distribution (``repro_torch.dist``,
``launch.mesh``, ``Engine(mesh=)``) against the JAX reference's.

Ranks are processes of one CPU host in a gloo group (``torch_dist_parity``
spawns them); the reference's side runs once, in this process, on the same
numpy parameters and batches.

- ``Engine(mesh=)`` at world 2: ``value_and_norms``,
  ``value_grads_and_norms``, ``clipped_step`` and ``step([Clip, GNS])`` on
  llama3.2-1b and on phi3.5-moe at ``capacity_factor=8`` (no drops, so no
  coupling across shards) against the reference's single-device
  ``Engine``, at the reference selfcheck's tolerances (loss 1e-5, norms
  1e-4, gradients rtol 1e-4 / atol 1e-5); both ranks' results bit for bit
  equal.
- One shard: at world 1 the mesh path on the toy loss equals the port's
  local path at rtol 1e-6 (``tests/test_sharded_pex.py``'s bar) and the
  reference's ``Engine`` on a one-device mesh.
- Several data axes: a (2, 2, 1) ("pod", "data", "model") mesh over 4 ranks
  with ``data_axes=("pod", "data")`` against the local ``Engine``, and the
  mesh helpers on that real mesh.
- Refusals: a model axis of extent 2, a non-empty aux, a batch and an
  importance ``k`` the shards do not divide raise the reference's error
  types.
- ``python -m repro_torch.dist.selfcheck --device cpu --world-size 4``.
- ``pad_to``, ``local_batch``, ``axis_size`` and ``spec`` against the
  reference's on the same extents and rules.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist_parity as tdp
from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.dist import sharding as jshd
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import pex
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 8, 8
ARCHS = {"llama3.2-1b": None, "phi3.5-moe": 8}
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _close(got, want, rtol, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _close_trees(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, GRAD_RTOL, GRAD_ATOL)


def _case(arch, capacity=None, clip=True):
    """What the ranks get: numpy params and batch and, with ``clip``, half
    the median per-example norm of the reference's grads+norms pass as
    the clip threshold (the reference selfcheck's); with the reference's
    objects for its remaining passes."""
    jspec = jreg.get(arch)
    jcfg = tdp.edit_cfg(jspec.smoke(), capacity)
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B), 3)
    case = {"arch": arch, "capacity": capacity, "clip": 1.0,
            "params": jax.tree_util.tree_map(np.asarray, jparams),
            "batch": {k: np.asarray(v) for k, v in jbatch.items()}}
    if not clip:
        return case, None
    loss = jreg.make_loss_fn_v2(jspec, jcfg)
    eng = jpex.Engine(jpex.PexSpec())
    g = jax.jit(lambda p, b: eng.value_grads_and_norms(loss, p, b))(
        jparams, jbatch)
    case["clip"] = 0.5 * float(np.sqrt(np.median(np.sum(
        np.asarray(g.sq_norms), -1))))
    return case, (eng, loss, jparams, jbatch, g)


def _reference(case, eng, loss, jparams, jbatch, g):
    """The reference Engine's four passes on a case."""
    clip = case["clip"]

    def rest(p, b):
        return {"norms": eng.value_and_norms(loss, p, b),
                "clipped": eng.clipped_step(loss, p, b, clip_norm=clip),
                "plan": eng.step(loss, p, b, [jpex.Clip(clip),
                                              jpex.GNS()])}

    return dict(jax.jit(rest)(jparams, jbatch), grads=g)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 job in one group: the four passes per arch, and the
    refusals. The reference's passes run while the ranks do."""
    cases, partial = {}, {}
    for arch, capacity in ARCHS.items():
        cases[arch], partial[arch] = _case(arch, capacity)
    todo = [(arch, tdp.engine_passes, case) for arch, case in cases.items()]
    todo.append(("refusals", tdp.refusals, cases["llama3.2-1b"]))
    ranks = tdp.start(tmp_path_factory.mktemp("world2"), 2, tdp.jobs, todo)
    refs = {arch: _reference(cases[arch], *partial[arch]) for arch in ARCHS}
    return refs, ranks()


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("pass_", ["norms", "grads", "clipped", "plan"])
def test_engine_mesh_pass_matches_reference(world2, arch, pass_):
    refs, ranks = world2
    want, got = refs[arch][pass_], ranks[0][arch][pass_]
    _close(got["loss"], want.loss, LOSS_RTOL)
    if pass_ in ("norms", "grads"):
        _close(got["loss_vec"], want.loss_vec, LOSS_RTOL)
    if pass_ != "plan":
        _close(got["sq_norms"], want.sq_norms, NORM_RTOL)
    if pass_ == "plan":
        _close(got["gns"], want.gns, NORM_RTOL)
        _close(got["weights"], want.weights, NORM_RTOL)
        _close(got["clip_coef"], want.clip_coef, NORM_RTOL)
    if pass_ != "norms":
        _close_trees(got["grads"], want.grads)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dist_pex_functions_are_the_engine_passes(world2, arch):
    """``dist.pex``'s ``value_and_norms``, ``value_grads_and_norms`` and
    ``clipped_value_and_grads`` on the explicit-accumulator loss give the
    mesh Engine's bits; ``gradient_noise_scale`` its formula's."""
    refs, ranks = world2
    got = ranks[0][arch]
    fn = got["functions"]
    np.testing.assert_array_equal(fn["norms"], got["norms"]["sq_norms"])
    np.testing.assert_array_equal(fn["loss"], got["grads"]["loss"])
    for tag in ("grads", "clipped"):
        for x, y in zip(jax.tree_util.tree_leaves(fn[tag]),
                        jax.tree_util.tree_leaves(got[tag]["grads"])):
            np.testing.assert_array_equal(x, y)
    want = jpex.gradient_noise_scale(refs[arch]["grads"].sq_norms,
                                     refs[arch]["grads"].grads)
    _close(fn["gns"], want, NORM_RTOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_mesh_results_bitwise_equal_across_ranks(world2, arch):
    _, ranks = world2
    a, b = ranks[0][arch], ranks[1][arch]
    for pass_ in a:
        la = jax.tree_util.tree_leaves(a[pass_])
        lb = jax.tree_util.tree_leaves(b[pass_])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y, err_msg=f"{arch} {pass_}")


@pytest.mark.parametrize("what, raised", [
    ("model_axis", "NotImplementedError"),    # reference pex._wrap
    ("aux", "NotImplementedError"),           # reference pex._reject_aux
    ("batch", "ValueError"),                  # reference local_batch
    ("importance_k", "ValueError"),           # local_batch of k
    ("aux_local", "nothing")])                # the local path keeps aux
def test_mesh_refusals_raise_reference_error_types(world2, what, raised):
    _, ranks = world2
    assert ranks[0]["refusals"][what] == raised
    assert ranks[1]["refusals"][what] == raised


def _toy_loss_j(params, batch, tap):
    z = tap.dense(batch["x"], params["w"], group="all")
    return jax.numpy.sum(jax.numpy.square(z), axis=tuple(range(1, z.ndim))), {}


def _toy_loss(params, batch, tap):
    z = tap.dense(batch["x"], params["w"], group="all")
    return torch.sum(torch.square(z), dim=tuple(range(1, z.ndim))), {}


def test_one_shard_mesh_equals_local_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    x = rng.normal(size=(8, 3, 6)).astype(np.float32)
    jmesh = jshd.make_mesh((1, 1), ("data", "model"))
    jeng = jpex.Engine(jpex.PexSpec(), clip_norm=1.0, mesh=jmesh)
    jref = jeng.value_grads_and_norms(_toy_loss_j, {"w": jax.numpy.asarray(w)},
                                      {"x": jax.numpy.asarray(x)})
    jref_c = jeng.clipped_step(_toy_loss_j, {"w": jax.numpy.asarray(w)},
                               {"x": jax.numpy.asarray(x)})
    params, batch = {"w": torch.as_tensor(w)}, {"x": torch.as_tensor(x)}
    local = pex.Engine(pex.PexSpec(), clip_norm=1.0)
    with tdp.one_rank(tmp_path):
        mesh = shd.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        sharded = pex.Engine(pex.PexSpec(), clip_norm=1.0, mesh=mesh)
        got = sharded.value_grads_and_norms(_toy_loss, params, batch)
        got_c = sharded.clipped_step(_toy_loss, params, batch)
    ref = local.value_grads_and_norms(_toy_loss, params, batch)
    ref_c = local.clipped_step(_toy_loss, params, batch)
    for g, want in ((got.loss, ref.loss), (got.sq_norms, ref.sq_norms),
                    (got.grads["w"], ref.grads["w"]),
                    (got_c.grads["w"], ref_c.grads["w"])):
        _close(g, want, 1e-6, atol=0)
    for g, want in ((got.loss, jref.loss), (got.sq_norms, jref.sq_norms),
                    (got.grads["w"], jref.grads["w"]),
                    (got_c.grads["w"], jref_c.grads["w"])):
        _close(g, want, 1e-5)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    case, _ = _case("llama3.2-1b", clip=False)
    return tdp.spawn(tmp_path_factory.mktemp("world4"), 4, tdp.jobs,
                     [("axes", tdp.several_data_axes, case)])


def test_several_data_axes_equal_local(world4):
    for rank in world4:
        got, want = rank["axes"]["mesh"], rank["axes"]["local"]
        _close(got["loss"], want["loss"], LOSS_RTOL)
        _close(got["loss_vec"], want["loss_vec"], LOSS_RTOL)
        _close(got["sq_norms"], want["sq_norms"], NORM_RTOL)
        _close(got["gns"], want["gns"], NORM_RTOL)
        _close_trees(got["grads"], want["grads"])
        _close_trees(got["plan"], want["plan"])
    first = jax.tree_util.tree_leaves(world4[0]["axes"]["mesh"]["grads"])
    for rank in world4[1:]:
        for x, y in zip(first, jax.tree_util.tree_leaves(
                rank["axes"]["mesh"]["grads"])):
            np.testing.assert_array_equal(x, y)


def test_mesh_helpers_on_a_real_mesh(world4):
    got = [r["axes"]["mesh"] for r in world4]
    assert [g["shard"] for g in got] == [(0, 4), (1, 4), (2, 4), (3, 4)]
    for g in got:
        assert g["local_batch"] == 2 and g["axis_size"] == 4
        assert g["placements"] == [("Shard", 0), ("Shard", 0),
                                   ("Shard", 2)]
        assert g["tree"] == ["b", "w", 1]
        assert g["production"] == "ValueError"
        assert g["over_too_few"] == "ValueError"
    assert [g["sub_coordinate"] for g in got] == [[0, 0], [1, 0], None,
                                                  None]


def test_selfcheck_world_4_subprocess():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.selfcheck", "--device",
         "cpu", "--world-size", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS: 4-way data-parallel" in r.stdout, r.stdout
    assert "FAIL" not in r.stdout


def _stand_in(shape, axes):
    """Meshes of any extent without that many ranks or devices: each
    package's helpers read only the axis names and extents."""
    return (types.SimpleNamespace(shape=dict(zip(axes, shape))),
            types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                  mesh=torch.empty(shape)))


@pytest.mark.parametrize("shape, axes", [((1, 1), ("data", "model")),
                                         ((4, 2), ("data", "model")),
                                         ((2, 16, 16),
                                          ("pod", "data", "model"))])
def test_sharding_arithmetic_matches_reference(shape, axes):
    jmesh, mesh = _stand_in(shape, axes)
    for rule in (None, "data", ("data",), ("pod", "data"), "model",
                 ("data", "model"), (None, "data")):
        if rule is not None and any(a is not None and a not in axes
                                    for a in np.atleast_1d(rule)):
            continue
        assert shd.axis_size(rule, mesh) == jshd.axis_size(rule, jmesh)
        for b in (512, 7, 64, 1):
            try:
                want = jshd.local_batch(b, rule, jmesh)
            except ValueError as e:
                with pytest.raises(ValueError, match="divisible") as got:
                    shd.local_batch(b, rule, mesh)
                assert str(got.value) == str(e)
                assert "pad_to" in str(got.value)
            else:
                assert shd.local_batch(b, rule, mesh) == want
    for n, m in ((0, 4), (5, 4), (8, 4), (9, 1), (1, 16)):
        assert shd.pad_to(n, m) == jshd.pad_to(n, m)
    for m in (0, -2):
        with pytest.raises(ValueError):
            jshd.pad_to(4, m)
        with pytest.raises(ValueError):
            shd.pad_to(4, m)


def test_spec_and_shard_match_reference():
    rules = {"batch": ("pod", "data"), "mlp": "model", "heads": None,
             "seq": (None,), "embed": ("data", None)}
    queries = [("batch", None, "mlp"), ("heads", "seq", "embed"),
               ("unmapped", "batch"), ()]
    for q in queries:
        with jshd.use_rules(None, rules), shd.use_rules(None, rules):
            assert shd.spec(*q) == tuple(jshd.spec(*q))
    assert shd.spec("batch") == (None,)           # no active rules
    x = torch.ones(2, 3)
    assert shd.shard(x, "batch", None) is x       # no mesh: identity
    _, mesh = _stand_in((2, 1), ("data", "model"))
    with shd.use_rules(mesh, rules):
        assert shd.current_rules()[0] is mesh and shd.active_mesh() is mesh
        assert shd.shard(x, "heads", None) is x   # resolves to no axis
        with pytest.raises(NotImplementedError, match="item 12"):
            shd.shard(x, "batch", None)
    with pytest.raises(RuntimeError, match="requires a mesh"):
        shd.sharding_for(("batch",))


def test_host_mesh_refuses_a_model_axis_that_does_not_divide(tmp_path):
    with tdp.one_rank(tmp_path):
        mesh = make_host_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model_parallel=2, device_type="cpu")
