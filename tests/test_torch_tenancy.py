"""The port's multi-tenant LoRA service against the JAX reference's.

Same numpy inputs through both packages: ``assemble`` (perm, inv_perm,
counts, the sorted batch and ``tenant_index``), the ``per_tenant_*``
reductions, and ``TenantService.step`` at 110 tenants of ragged 1–4
examples (the reference test's mix) at example and token granularity —
per-example (per-token) norms, clip coefficients, ``tenant_loss``,
``tenant_count`` and every tenant's updated store row at rtol 1e-5, atol
1e-6. The port's store rows are the reference's ``AdapterStore`` rows,
carried over by ``interop``; the reference's per-tenant noise samples
(``normal`` of ``split(fold_in(rng, t), leaves)``) are handed to the port
through its one draw site, ``passes._standard_normal``, tenant by tenant
in the batch's order, as the plain noise's tests do.

The port's own noise: the segmented rows are bit for bit ``add_grad_noise``
on each tenant's tree alone with its derived generator, a tenant's noise
does not change with its batchmates, two steps draw different noise, and
the fused service step matches a loop of single-tenant engines (the
reference test's oracle) with the port's own draws. Store recycling,
re-admission, the pending queue and the errors follow.

The reference test's ``shard_map`` variants are held at two ranks in
``tests/test_torch_dist_train.py``; here a one-rank mesh steps as the local
service does. The store's checkpoint round trip is here too; the
renumbering restore and the too-small store are in
``tests/test_torch_ckpt.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_parity as tdp
from repro.nn import lora as jlora
from repro.nn.linear import linear as jlinear
from repro.tenancy import AdapterStore as JStore
from repro.tenancy import TenantService as JService
from repro.tenancy import assemble as jassemble
from repro.tenancy import batch as jtb
from repro_torch import interop, pex
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import passes
from repro_torch.dist import sharding as shd
from repro_torch.nn import lora as tlora
from repro_torch.nn import param as pm
from repro_torch.nn.linear import linear
from repro_torch.tenancy import AdapterStore, TenantService, assemble
from repro_torch.tenancy import batch as ttb

D, O, R, S = 6, 4, 2, 5
ALPHA = 8.0
C, SIGMA, LR = 1.0, 0.3, 0.1
RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")
W_BASE = (0.3 * np.random.default_rng(0).standard_normal((D, O))).astype(
    np.float32)


def _init_fn(gen):
    return {"site": tlora.init_pair(gen, D, O, R, ALPHA, device=gen.device,
                                    b_std=0.4)}


def _jinit_fn(key):
    return {"site": jlora.init_pair(key, D, O, R, ALPHA, boxed=False,
                                    b_std=0.4)}


def _loss_fn(adapters, data, tap):
    p = {"w": torch.as_tensor(W_BASE), "lora": adapters["site"]}
    z = linear(p, data["x"], tap=tap, group="all")
    tok = tap.token_loss(torch.sum(torch.square(z - data["y"]), dim=-1))
    return torch.sum(tok, dim=1), {}


def _jloss_fn(adapters, data, tap):
    p = {"w": jnp.asarray(W_BASE), "lora": adapters["site"]}
    z = jlinear(p, data["x"], tap=tap, group="all")
    tok = tap.token_loss(jnp.sum(jnp.square(z - data["y"]), axis=-1))
    return jnp.sum(tok, axis=1), {}


def _mixed(n_tenants=110, max_per=4, seed=7):
    """Interleaved mixed-tenant batch: ragged 1..max_per examples per
    tenant, shuffled (numpy)."""
    rs = np.random.RandomState(seed)
    tenants = rs.choice(np.arange(1000, 50_000), size=n_tenants,
                        replace=False)
    owner = np.concatenate(
        [np.full(rs.randint(1, max_per + 1), t) for t in tenants])
    rs.shuffle(owner)
    b = len(owner)
    x = rs.standard_normal((b, S, D)).astype(np.float32)
    y = rs.standard_normal((b, S, O)).astype(np.float32)
    return x, y, owner


def _batch(x, y):
    return {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# assembly and reductions against the reference
# ---------------------------------------------------------------------------

def test_assemble_matches_reference():
    x, y, owner = _mixed(n_tenants=40, seed=3)
    j = jassemble({"x": jnp.asarray(x), "y": jnp.asarray(y)}, owner)
    t = assemble(_batch(x, y), owner)
    for k in ("tenant_ids", "unique_tenants", "counts", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.n_tenants == j.n_tenants and t.batch_size == j.batch_size
    np.testing.assert_array_equal(t.tenant_index.numpy(),
                                  np.asarray(j.tenant_index))
    for k in ("x", "y"):
        np.testing.assert_array_equal(t.batch[k].numpy(),
                                      np.asarray(j.batch[k]))
    np.testing.assert_array_equal(t.segments().numpy(),
                                  np.asarray(j.segments()))
    # a bare tensor batch rides under "data", as in the reference
    bare = assemble(torch.as_tensor(x), owner)
    assert set(bare.batch) == {"data", "tenant_index"}


def test_assemble_rejects_bad_ids():
    x, y, owner = _mixed(n_tenants=3, max_per=1)
    with pytest.raises(ValueError):
        assemble(_batch(x, y), np.array([-1] * len(owner)))
    with pytest.raises(ValueError):
        assemble(_batch(x, y), owner[None])
    with pytest.raises(ValueError):
        assemble({"tenant_index": torch.as_tensor(x)}, owner)


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count"])
def test_per_tenant_reductions_match_reference(fn):
    rs = np.random.default_rng(1)
    idx = np.sort(rs.integers(0, 9, 40))
    idx = np.unique(idx, return_inverse=True)[1].reshape(-1)
    n = int(idx.max()) + 1
    v = rs.standard_normal((40, 3)).astype(np.float32)
    ji, ti = jnp.asarray(idx, jnp.int32), torch.as_tensor(idx)
    if fn == "count":
        got = ttb.per_tenant_count(ti, n)
        want = jtb.per_tenant_count(ji, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    got = getattr(ttb, f"per_tenant_{fn}")(torch.as_tensor(v), ti, n)
    want = getattr(jtb, f"per_tenant_{fn}")(jnp.asarray(v), ji, n)
    _close(got, want)


# ---------------------------------------------------------------------------
# the store and the service's bookkeeping
# ---------------------------------------------------------------------------

def _digest(tree):
    return [x.clone() for x in pm.tree_leaves(tree)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_store_slot_recycling_and_deterministic_readmission():
    store = AdapterStore(_init_fn, capacity=3, seed=0, device="cpu")
    s5, s9 = store.admit(5), store.admit(9)
    assert store.admit(5) == s5
    first = _digest(store.gather([5]))
    assert not _same(first, _digest(store.gather([9])))
    store.admit(2)
    with pytest.raises(RuntimeError, match="full"):
        store.admit(77)
    store.evict(9)
    assert all(torch.count_nonzero(s[s9]) == 0
               for s in pm.tree_leaves(store.stacked))
    assert store.admit(77) == s9
    store.evict(77)
    store.evict(5)
    store.admit(5)
    assert _same(_digest(store.gather([5])), first)
    assert list(store.tenants) == [2, 5] and store.n_free == 1
    with pytest.raises(KeyError, match="not resident"):
        store.gather([404])
    with pytest.raises(ValueError):
        store.admit(-1)
    # a store with another seed draws other rows
    other = AdapterStore(_init_fn, capacity=1, seed=1, device="cpu")
    other.admit(5)
    assert not _same(_digest(other.gather([5])), first)


def test_store_scatter_roundtrip_and_checkpointing(tmp_path):
    """``scatter`` inverts ``gather``; ``save`` writes the active rows in
    tenant-id order with the tenant list in ``extra``, and ``restore`` puts
    them back, bit for bit, into slots [0..n) of a store of another seed
    whose residency differs."""
    store = AdapterStore(_init_fn, capacity=4, seed=3, device="cpu")
    for t in (8, 4):
        store.admit(t)
    rows = store.gather([8, 4])
    store.scatter([8, 4], pm.tree_map(lambda v: v + 1.0, rows))
    again = store.gather([8, 4])
    for a, b in zip(pm.tree_leaves(again), pm.tree_leaves(rows)):
        torch.testing.assert_close(a, b + 1.0, rtol=0, atol=0)
    mgr = CheckpointManager(str(tmp_path))
    store.save(mgr, 3)
    _, extra = mgr.restore(3, store.gather([4, 8]))
    assert extra == {"tenancy": {"tenants": [4, 8]}}
    other = AdapterStore(_init_fn, capacity=4, seed=9, device="cpu")
    for t in (1, 8, 2):
        other.admit(t)
    assert other.restore(mgr) == [4, 8]
    assert list(other.slots) == [4, 8, -1, -1] and list(other.tenants) == \
        [4, 8]
    assert _same(_digest(other.gather([4, 8])),
                 _digest(store.gather([4, 8])))
    assert all(torch.count_nonzero(s[2:]) == 0
               for s in pm.tree_leaves(other.stacked))


def test_service_pending_queue_head_first():
    store = AdapterStore(_init_fn, capacity=2, seed=0, device="cpu")
    svc = TenantService(store, _loss_fn, clip_norm=C)
    svc.submit(10, 11, 12)
    assert svc.admit_pending() == [10, 11]
    assert svc.pending == [12]
    svc.evict(10)
    assert svc.admit_pending() == [12]


def test_service_errors(tmp_path):
    store = AdapterStore(_init_fn, capacity=4, seed=0, device="cpu")
    x, y, owner = _mixed(n_tenants=2, max_per=1)
    svc = TenantService(store, _loss_fn, clip_norm=C, noise_std=SIGMA,
                        granularity="token")
    with pytest.raises(ValueError, match="noise_scale"):
        svc.step(_batch(x, y), owner, rng=torch.Generator())
    svc = TenantService(store, _loss_fn, clip_norm=C, noise_std=SIGMA)
    with pytest.raises(ValueError, match="rng"):
        svc.step(_batch(x, y), owner)
    # a one-rank mesh steps as the local service does, bit for bit
    # (tests/test_torch_dist_train.py holds two ranks to the reference)
    local = TenantService(AdapterStore(_init_fn, capacity=4, seed=0,
                                       device="cpu"), _loss_fn, clip_norm=C)
    want = local.step(_batch(x, y), owner)
    with tdp.one_rank(tmp_path):
        meshed = TenantService(
            AdapterStore(_init_fn, capacity=4, seed=0, device="cpu"),
            _loss_fn, clip_norm=C,
            mesh=shd.make_mesh((1,), ("data",), device_type="cpu"))
        got = meshed.step(_batch(x, y), owner)
    for g, w in ((got.loss_vec, want.loss_vec), (got.sq_norms,
                                                 want.sq_norms)):
        assert torch.equal(g, w)
    for g, w in zip(pm.tree_leaves(meshed.store.gather(owner)),
                    pm.tree_leaves(local.store.gather(owner))):
        assert torch.equal(g, w)
    # checkpointing needs a manager, as in the reference
    with pytest.raises(ValueError, match="ckpt_manager= to checkpoint"):
        svc.save()
    with pytest.raises(ValueError, match="ckpt_manager= to restore"):
        svc.restore()
    saved = TenantService(local.store, _loss_fn, clip_norm=C,
                          ckpt_manager=CheckpointManager(str(tmp_path / "ck")))
    saved.save()
    assert saved.ckpt_manager.all_steps() == [0]
    assert saved.restore() == sorted(int(t) for t in set(owner))


# ---------------------------------------------------------------------------
# the fused 110-tenant step against the reference's
# ---------------------------------------------------------------------------

def _reference_samples(rng, tenants, row_shapes):
    """The reference's per-tenant N(0, 1) draws, tenant-major, leaf-minor:
    ``normal(split(fold_in(rng, t), n_leaves)[i], row shape i)``."""
    out = []
    for t in tenants:
        keys = jax.random.split(jax.random.fold_in(rng, int(t)),
                                len(row_shapes))
        out += [torch.tensor(np.asarray(
            jax.random.normal(k, shape, jnp.float32)))
            for k, shape in zip(keys, row_shapes)]
    return out


@pytest.mark.parametrize("granularity", ["example", "token"])
def test_service_step_matches_reference(granularity, monkeypatch):
    x, y, owner = _mixed(n_tenants=110, seed=7)
    rng = jax.random.PRNGKey(99)
    tenants = np.unique(owner)
    jstore = JStore(_jinit_fn, capacity=128, key=jax.random.PRNGKey(7))
    for t in tenants:
        jstore.admit(int(t))
    rows = jax.tree_util.tree_map(np.asarray, jstore.gather(tenants))
    store = AdapterStore(_init_fn, capacity=128, seed=7, device="cpu")
    for t in tenants:
        store.admit(int(t))
    store.scatter(tenants, interop.params_from_numpy(rows, device="cpu"))

    jsvc = JService(jstore, _jloss_fn, clip_norm=C, noise_std=SIGMA,
                    noise_scale=C, lr=LR, granularity=granularity)
    jres = jsvc.step({"x": jnp.asarray(x), "y": jnp.asarray(y)}, owner,
                     rng=rng)
    draws = _reference_samples(rng, tenants, [(D, R), (R, O)])

    def injected(shape, generator, device):
        d = draws.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return d

    monkeypatch.setattr(passes, "_standard_normal", injected)
    svc = TenantService(store, _loss_fn, clip_norm=C, noise_std=SIGMA,
                        noise_scale=C, lr=LR, granularity=granularity)
    res = svc.step(_batch(x, y), owner, rng=torch.Generator().manual_seed(1))
    assert draws == []
    np.testing.assert_array_equal(res.tenant_ids, jres.tenant_ids)
    np.testing.assert_array_equal(res.tenant_count.numpy(),
                                  np.asarray(jres.tenant_count))
    _close(res.sq_norms, jres.sq_norms)
    _close(res.clip_coef, jres.clip_coef)
    _close(res.loss_vec, jres.loss_vec)
    _close(res.tenant_loss, jres.tenant_loss)
    if granularity == "example":
        _close(res.tenant_clip_mean, jres.tenant_clip_mean)
        _close(res.tenant_clip_min, jres.tenant_clip_min)
    else:
        assert res.tenant_clip_mean is None
    got = store.gather(tenants)["site"]
    want = jstore.gather(tenants)["site"]
    _close(got.a, want.a)
    _close(got.b, want.b)


# ---------------------------------------------------------------------------
# the port's own per-tenant noise
# ---------------------------------------------------------------------------

def _stacked(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(n, D, R, generator=g),
            "b": torch.randn(n, R, O, generator=g).to(torch.bfloat16)}


def test_segmented_noise_bitwise_per_tenant():
    tenants = torch.tensor([3, 11, 12, 907])
    tree = _stacked(4)
    noised = passes.add_grad_noise_segmented(
        pm.tree_map(torch.clone, tree), SIGMA, C,
        torch.Generator().manual_seed(5), tenants)
    seed = passes.step_seed(torch.Generator().manual_seed(5))
    for i, t in enumerate(tenants.tolist()):
        alone = passes.add_grad_noise({k: v[i].clone() for k, v in
                                       tree.items()}, SIGMA, C,
                                      passes.tenant_generator(seed, t, CPU))
        for k in tree:
            assert torch.equal(noised[k][i], alone[k]), (t, k)
            assert not torch.equal(noised[k][i], tree[k][i])
    with pytest.raises(ValueError, match="segments"):
        passes.add_grad_noise_segmented(_stacked(3), SIGMA, C,
                                        torch.Generator(), tenants)


def test_tenant_noise_ignores_batchmates_and_changes_each_step():
    def noise_of(tenants, rng):
        zero = pm.tree_map(torch.zeros_like, _stacked(len(tenants)))
        return passes.add_grad_noise_segmented(zero, SIGMA, C, rng,
                                               torch.tensor(tenants))

    a = noise_of([3, 11, 12], torch.Generator().manual_seed(5))
    b = noise_of([1, 11, 40, 41], torch.Generator().manual_seed(5))
    for k in a:
        assert torch.equal(a[k][1], b[k][1])        # tenant 11
        assert not torch.equal(a[k][0], a[k][1])
    rng = torch.Generator().manual_seed(5)
    first, second = noise_of([11], rng), noise_of([11], rng)
    for k in first:
        assert not torch.equal(first[k], second[k])
    # the per-tenant draws have the noise's moments
    big = noise_of(list(range(400)), torch.Generator().manual_seed(2))["a"]
    assert abs(big.mean().item()) < 0.05 * SIGMA * C
    assert abs(big.std().item() - SIGMA * C) < 0.05 * SIGMA * C


@pytest.mark.parametrize("granularity", ["example", "token"])
def test_service_step_matches_single_tenant_engines(granularity):
    """The reference test's oracle with the port's own draws: each tenant's
    norms, clip coefficients and noised row equal one single-tenant Engine
    step on its own examples, noised from its derived generator."""
    x, y, owner = _mixed(n_tenants=24, seed=11)
    store = AdapterStore(_init_fn, capacity=32, seed=4, device="cpu")
    svc = TenantService(store, _loss_fn, clip_norm=C, noise_std=SIGMA,
                        noise_scale=C, lr=LR, granularity=granularity)
    rng = torch.Generator().manual_seed(99)
    seed = passes.step_seed(torch.Generator().manual_seed(99))
    res = svc.step(_batch(x, y), owner, rng=rng)
    tb = assemble(_batch(x, y), owner)
    oracle = pex.Engine(pex.PexSpec(), granularity=granularity)
    for t in tb.unique_tenants:
        at = _init_fn(torch.Generator().manual_seed(pm.fold_seed(4, int(t))))
        idx = np.flatnonzero(owner == t)
        r_t = oracle.step(
            _loss_fn, at, _batch(x[idx], y[idx]),
            [pex.Clip(C, granularity=granularity),
             pex.Noise(SIGMA, passes.tenant_generator(seed, int(t), CPU),
                       scale=C)])
        pos = np.flatnonzero(tb.tenant_ids == t)
        _close(res.sq_norms[pos].sum(-1), r_t.sq_norms.sum(-1))
        _close(res.clip_coef[pos], r_t.clip_coef)
        new = pm.tree_map(lambda a, g: a - LR * g, at, r_t.grads)
        got = store.gather([t])["site"]
        _close(got.a[0], new["site"].a)
        _close(got.b[0], new["site"].b)


@pytest.mark.parametrize("t,n_seg,p_in,p_out", [
    (512 * 64, 512, 256, 8),        # 256 tenants x 2, S=64: 2 tiles of G
    (1024 * 64, 1024, 8, 256),
    (320 * 512, 320, 2048, 8),      # llama3.2-1b's wq width: 16 tiles
    (3000, 1, 512, 384),            # one long segment: a depth of 1
])
def test_direct_depth_fills_the_card_within_the_list(t, n_seg, p_in, p_out):
    """The segmented kernel's direct route strides its list over a grid
    depth sized from static bounds: enough blocks per tile of G to give an
    H100 (132 SMs) 4 blocks an SM, never more than the list can hold."""
    from repro_torch.kernels import segmented_norm as sn
    lim = sn.limits(t, n_seg, p_in, p_out)
    tiles = -(-p_in // sn.DIRECT_TILE) * -(-p_out // sn.DIRECT_TILE)
    depth = sn.direct_depth(lim.directs, tiles, 132)
    assert 1 <= depth <= lim.directs
    assert depth * tiles >= sn.BLOCKS_PER_SM * 132 or depth == lim.directs
    # every list entry is walked by exactly one block of each tile
    walked = sorted(q for z in range(depth)
                    for q in range(z, lim.directs, depth))
    assert walked == list(range(lim.directs))
