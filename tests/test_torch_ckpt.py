"""The port's checkpointing against the reference's.

``repro_torch.ckpt.CheckpointManager`` is held to ``tests/test_substrate.py``'s
cases of the reference's manager: the round trip with ``keep`` and atomic
commits, corruption detected, the fall-back past a corrupt and a truncated
step, a writer failure surfacing at ``wait()``, the stale ``.tmp`` sweep,
and (the port's mesh) ``shardings=`` onto a one-rank CPU mesh. The two
packages' managers read each other's files: the same numpy tree (f32,
bf16 and int leaves) saved by one restores bit for bit in the other, and
both write the same manifest keys, shapes and dtypes.

The ``Trainer``: 4 steps straight equal 2 + resume + 2 bit for bit (the
port's ``tests/test_substrate.py::test_checkpoint_resume_is_bit_deterministic``),
and ``_validate_extra`` refuses the reference's three bad resumes
(``tests/test_soak.py::test_trainer_rejects_incomplete_or_mismatched_resume``).
The tenant store: a renumbering restore is bit for bit per tenant, and a
restore into too small a store raises
(``tests/test_lora_tenancy.py``'s two checkpoint cases).
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_dist_parity as tdp
from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro_torch import ft
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import plan as tplan
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import registry
from repro_torch.nn import lora as tlora
from repro_torch.nn import param as pm
from repro_torch.nn.linear import linear
from repro_torch.optim import adamw
from repro_torch.tenancy import AdapterStore, TenantService
from repro_torch.train.trainer import TrainConfig, Trainer

BF16 = torch.bfloat16


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=BF16) / 3}}


def _same(a, b):
    la, lb = pm.tree_leaves(a), pm.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_atomic_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"step": step}, block=True)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    like = pm.tree_map(torch.zeros_like, tree)
    restored, extra = mgr.restore(None, like)
    assert extra["step"] == 3 and mgr.last_restored_step == 3
    assert _same(restored, tree)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with open(tmp_path / "step_000000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["['a']", "['b']['c']"]
    assert manifest["dtypes"] == ["float32", "bfloat16"]
    assert manifest["shapes"] == [[2, 3], [4]]
    assert set(manifest) == {"step", "num_hosts", "keys", "shapes",
                             "dtypes", "shard_hash", "extra"}
    # the leaf's dtype comes from the like tree, its shape from the file
    up, _ = mgr.restore(2, {"a": torch.zeros(1, dtype=torch.float64),
                            "b": {"c": torch.zeros(1)}})
    assert up["a"].dtype == torch.float64 and up["a"].shape == (2, 3)
    assert torch.equal(up["b"]["c"], tree["b"]["c"].float())
    # the save copied the leaves: changing them in place changes no file
    tree["a"].add_(1.0)
    again, _ = mgr.restore(3, like)
    assert torch.equal(again["a"], restored["a"])


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    tree = {"a": torch.ones(8)}
    mgr.save(7, tree, block=True)
    shard = os.path.join(mgr._step_dir(7), "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="tried: step 7: OSError: checkpoint "
                                      "shard corrupt at step 7"):
        mgr.restore(7, tree)


def test_checkpoint_restore_falls_back_past_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    like = {"a": torch.ones(8)}
    for s in (5, 6, 7):
        mgr.save(s, {"a": torch.full((8,), float(s))}, extra={"step": s},
                 block=True)
    assert ft.corrupt_newest_checkpoint(str(tmp_path)) == 7
    with pytest.warns(UserWarning, match="falling back"):
        tree, extra = mgr.restore(None, like)
    assert extra["step"] == 6 and mgr.last_restored_step == 6
    assert torch.equal(tree["a"], torch.full((8,), 6.0))
    # truncate 6 as well: falls all the way to 5
    assert ft.corrupt_newest_checkpoint(str(tmp_path), truncate=True) == 7
    with open(os.path.join(mgr._step_dir(6), "shard_00000.npz"),
              "r+b") as f:
        f.truncate(4)
    with pytest.warns(UserWarning):
        _, extra = mgr.restore(None, like)
    assert extra["step"] == 5 and mgr.last_restored_step == 5
    # a step asked for falls back only to earlier steps
    with pytest.warns(UserWarning):
        _, extra = mgr.restore(6, like)
    assert extra["step"] == 5
    # only when *no* committed step is restorable does restore raise,
    # naming every step it tried
    with open(os.path.join(mgr._step_dir(5), "shard_00000.npz"),
              "r+b") as f:
        f.truncate(4)
    with pytest.raises(IOError, match="step 7: .*; step 6: .*; step 5: "):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.restore(None, like)


def test_checkpoint_writer_failure_surfaces_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.ones(4)}
    # block the async writer's tmp dir with a *file*: its makedirs fails on
    # the background thread, where an uncaught exception would vanish
    open(os.path.join(str(tmp_path), "step_000000005.tmp"), "w").close()
    mgr.save(5, tree)                       # async: no error here
    with pytest.raises(OSError):
        mgr.wait()                          # ...it surfaces here
    mgr.save(6, tree, block=True)           # captured error was consumed
    assert mgr.latest_step() == 6
    # and a failure surfaces at the next save, which waits first
    os.unlink(os.path.join(str(tmp_path), "step_000000005.tmp"))
    open(os.path.join(str(tmp_path), "step_000000008.tmp"), "w").close()
    mgr.save(8, tree)
    with pytest.raises(OSError):
        mgr.save(9, tree)


def test_checkpoint_sweeps_stale_tmp_on_construction(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"a": torch.ones(2)}, block=True)
    ft.litter_tmp_dir(str(tmp_path), step=99)
    assert any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with pytest.warns(UserWarning, match="sweeping"):
        mgr2 = CheckpointManager(str(tmp_path))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert mgr2.all_steps() == [3]          # committed data untouched


def test_checkpoint_restore_onto_a_mesh(tmp_path):
    """``shardings=`` takes what ``dist.sharding.sharding_for`` returns: a
    replicated placement puts every leaf on the mesh's device and checks
    the ranks hold the same bits; a sharded placement lays each leaf out
    as a DTensor of it (the model-axis route), holding the same bits."""
    from torch.distributed.tensor import Shard

    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = _tree()
    mgr.save(1, tree, block=True)
    like = pm.tree_map(torch.zeros_like, tree)
    with tdp.one_rank(tmp_path):
        mesh = shd.make_mesh((1,), ("data",), device_type="cpu")
        got, _ = mgr.restore(None, like, shardings=shd.sharding_for((), mesh))
        assert _same(got, tree)
        per_leaf = {"a": shd.sharding_for((None, None), mesh),
                    "b": {"c": shd.sharding_for((None,), mesh)}}
        got, _ = mgr.restore(1, like, shardings=per_leaf)
        assert _same(got, tree)
        got, _ = mgr.restore(1, like, shardings=shd.Sharding(mesh,
                                                            (Shard(0),)))
        assert all(shd.is_dtensor(x) and x.placements == (Shard(0),)
                   for x in pm.tree_leaves(got))
        assert _same(pm.tree_map(lambda x: x.full_tensor(), got), tree)


# ---------------------------------------------------------------------------
# the two packages read each other's files
# ---------------------------------------------------------------------------

def _numpy_tree():
    rng = np.random.default_rng(3)
    return {
        "params": {"blocks": [
            {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            {"w": rng.normal(size=(3, 4)).astype(np.float32)}],
            "emb": rng.normal(size=(5, 2)).astype(ml_dtypes.bfloat16)},
        # int32: JAX holds no int64 without x64
        "ids": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
        "step": np.asarray(11, np.int32),
    }


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """A leaf's raw bytes (numpy, jax or torch)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("keys", "shapes", "dtypes", "extra")}


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_files_swap_between_packages(tmp_path, direction):
    tree = _numpy_tree()
    ttree = {"params": {"blocks": [{"w": _to_torch(b["w"])}
                                   for b in tree["params"]["blocks"]],
                        "emb": _to_torch(tree["params"]["emb"])},
             "ids": _to_torch(tree["ids"]), "step": _to_torch(tree["step"])}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ja, ta = str(tmp_path / "jax"), str(tmp_path / "torch")
    JManager(ja).save(4, tree, extra={"who": "jax"}, block=True)
    CheckpointManager(ta).save(4, ttree, extra={"who": "jax"}, block=True)
    assert _manifest(ja, 4) == _manifest(ta, 4)
    want = [_bits(x) for x in jax.tree_util.tree_leaves(tree)]
    if direction == "reference_to_port":
        got, extra = CheckpointManager(ja).restore(
            None, pm.tree_map(torch.zeros_like, ttree))
        assert [x.dtype for x in pm.tree_leaves(got)] == \
            [x.dtype for x in pm.tree_leaves(ttree)]
        assert [_bits(x) for x in pm.tree_leaves(got)] == want
    else:
        got, extra = JManager(ta).restore(
            None, jax.tree_util.tree_map(jnp.zeros_like, jtree))
        assert [x.dtype for x in jax.tree_util.tree_leaves(got)] == \
            [x.dtype for x in jax.tree_util.tree_leaves(jtree)]
        assert [_bits(x) for x in jax.tree_util.tree_leaves(got)] == want
    assert extra == {"who": "jax"}


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _smoke_trainer(steps, ckpt_dir, ckpt_every):
    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    return Trainer(registry.make_loss_fn_v2(spec, cfg), params,
                   PexSpec(enabled=True, method="gram"),
                   adamw.AdamWConfig(lr=1e-3),
                   TrainConfig(steps=steps, log_every=0,
                               ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
                   DataConfig(vocab=cfg.vocab, seq=8, global_batch=4),
                   device="cpu")


def test_checkpoint_resume_is_bit_deterministic(tmp_path):
    """Train 4 steps straight vs 2 + restore + 2 — identical parameters,
    moments and optimizer step, and the resumed run's losses are the
    straight run's last two."""
    straight = _smoke_trainer(4, None, 10 ** 9)
    straight.train()
    d = str(tmp_path / "ck")
    first = _smoke_trainer(2, d, 2)
    first.train()
    assert first.ckpt.all_steps() == [2]
    resumed = _smoke_trainer(4, d, 10 ** 9)
    resumed.train(resume=True)
    assert resumed.step == 4 and resumed.opt_state.step == 4
    assert _same(resumed._state_tree(), straight._state_tree())
    assert [m["loss"] for m in resumed.metrics] == \
        [m["loss"] for m in straight.metrics[2:]]


def _toy_trainer(ckpt_dir, seed=0, data_seed=None):
    """Tiny linear model through the real Engine/Trainer machinery."""
    def loss_fn(params, batch, tap):
        x = batch["ids"].to(torch.float32)
        err = x @ params["w"] - batch["labels"].to(torch.float32)
        return torch.mean(torch.square(err), dim=-1), None

    return Trainer(
        ft.poison_loss_fn(loss_fn), {"w": torch.eye(4) * 0.5},
        PexSpec(enabled=True), adamw.AdamWConfig(lr=1e-2),
        TrainConfig(consumers=(tplan.Grads(),), steps=4, log_every=0,
                    ckpt_every=10 ** 9, ckpt_dir=ckpt_dir, seed=seed),
        DataConfig(vocab=16, seq=4, global_batch=4,
                   seed=seed if data_seed is None else data_seed),
        device="cpu")


def test_trainer_rejects_incomplete_or_mismatched_resume(tmp_path):
    d = str(tmp_path / "ck")
    t1 = _toy_trainer(d, seed=0)
    t1.save_checkpoint(block=True)
    # trainer seed mismatch: the rng/noise stream would fork
    with pytest.raises(ValueError, match="seed"):
        _toy_trainer(d, seed=1).restore_from()
    # data-stream seed mismatch: different batches would replay
    with pytest.raises(ValueError, match="data stream"):
        _toy_trainer(d, seed=0, data_seed=2).restore_from()
    # a checkpoint with no pipeline state names what's missing
    t1.ckpt.save(99, t1._state_tree(),
                 extra={"step": 99, "opt_step": 0, "seed": 0}, block=True)
    with pytest.raises(ValueError, match=r"missing key\(s\) \['data'\]"):
        _toy_trainer(d, seed=0).restore_from()
    # intact checkpoints restore fine
    assert _toy_trainer(d, seed=0).restore_from(step=0) == 0
    with pytest.raises(AssertionError, match="no ckpt_dir"):
        _toy_trainer(None).save_checkpoint()


# ---------------------------------------------------------------------------
# the tenant store
# ---------------------------------------------------------------------------

D, O, R, S = 6, 4, 2, 5
W_BASE = torch.as_tensor(
    (0.3 * np.random.default_rng(0).standard_normal((D, O))).astype(
        np.float32))


def _init_fn(gen):
    return {"site": tlora.init_pair(gen, D, O, R, 8.0, device=gen.device,
                                    b_std=0.4)}


def _loss_fn(adapters, data, tap):
    z = linear({"w": W_BASE, "lora": adapters["site"]}, data["x"], tap=tap,
               group="all")
    tok = tap.token_loss(torch.sum(torch.square(z - data["y"]), dim=-1))
    return torch.sum(tok, dim=1), {}


def test_ckpt_renumbering_is_bitexact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    store = AdapterStore(_init_fn, capacity=8, seed=13, device="cpu")
    svc = TenantService(store, _loss_fn, clip_norm=1.0, lr=0.1,
                        ckpt_manager=mgr)
    rs = np.random.default_rng(21)
    owner = rs.permutation(np.repeat(rs.choice(
        np.arange(100, 900), 5, replace=False), rs.integers(1, 3, 5)))
    batch = {k: torch.as_tensor(rs.standard_normal(
        (owner.size, S, n)).astype(np.float32)) for k, n in (("x", D),
                                                            ("y", O))}
    svc.step(batch, owner)  # trained state, not just init
    tenants = [int(t) for t in store.tenants]
    rows = {t: [x.clone() for x in pm.tree_leaves(store.gather([t]))]
            for t in tenants}
    svc.save(step=1)
    # scramble residency: evict some, admit others (slots renumber)
    store.evict(tenants[0])
    store.evict(tenants[2])
    store.admit(999_001)
    store.admit(999_002)
    restored = svc.restore()
    assert sorted(restored) == sorted(tenants)
    for t in tenants:
        assert all(torch.equal(a, b) for a, b in zip(
            pm.tree_leaves(store.gather([t])), rows[t])), t
    # survivors repacked into slots [0..n) in tenant-id order
    assert [int(t) for t in store.slots[:len(tenants)]] == sorted(tenants)
    assert all(s == -1 for s in store.slots[len(tenants):])
    assert not store.has(999_001)


def test_restore_into_too_small_store_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    big = AdapterStore(_init_fn, capacity=4, seed=0, device="cpu")
    for t in (1, 2, 3):
        big.admit(t)
    big.save(mgr, 0)
    small = AdapterStore(_init_fn, capacity=2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="restore into a larger store"):
        small.restore(mgr)
