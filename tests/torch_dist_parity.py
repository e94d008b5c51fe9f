"""Shared by ``tests/test_torch_dist.py`` and
``tests/test_torch_dist_train.py``: spawned gloo ranks of one CPU host and
the work each rank does.

The tests compute the reference's side once, in the parent process, and
hand it to the ranks as numpy; the ranks import no JAX (this module imports
only torch, numpy and the port). ``spawn`` starts ``world`` processes with
the ``spawn`` method (one thread each), joins them into a gloo group through
a ``file://`` store in the test's ``tmp_path`` (so that test workers never
share a port), runs ``fn(rank, world, *args)`` on each, destroys the group
and returns every rank's result, in rank order. ``one_rank`` is a world of
one rank in the calling process, for the one-shard checks. ``start`` is
``spawn`` that lets the caller work while the ranks run.
"""
import contextlib
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop, pex
from repro_torch.core import importance as timp
from repro_torch.core import passes
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import pex as dpex
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.nn import lora as tlora
from repro_torch.nn import param as pm
from repro_torch.nn.linear import linear
from repro_torch.optim import adamw
from repro_torch.optim import schedule as tsched
from repro_torch.tenancy import AdapterStore, TenantService, assemble
from repro_torch.train import trainer as ttrainer


def spawn(tmp_path, world: int, fn, *args) -> list:
    return start(tmp_path, world, fn, *args)()


def start(tmp_path, world: int, fn, *args):
    """``spawn`` that returns at once: call the result to wait for the
    ranks and get their results (the caller works meanwhile)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_entry, args=(world, str(tmp_path), fn, args),
                             nprocs=world, start_method="spawn", join=False)

    def results() -> list:
        while not ctx.join():
            pass
        out = []
        for r in range(world):
            with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    return results


def _entry(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@contextlib.contextmanager
def one_rank(tmp_path):
    """A gloo world of one rank in this process, for the body's extent."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def np_tree(tree):
    return interop.params_to_numpy(pm.tree_map(
        lambda x: x.detach().float() if isinstance(x, torch.Tensor) else x,
        tree))


def _np(x):
    return None if x is None else x.detach().float().numpy()


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _raised(fn) -> str:
    """The name of the exception type ``fn()`` raises (or "nothing")."""
    try:
        fn()
    except Exception as e:   # the tests compare the type's name
        return type(e).__name__
    return "nothing"


# ---------------------------------------------------------------------------
# Engine passes
# ---------------------------------------------------------------------------

def edit_cfg(cfg, moe_capacity):
    """``cfg`` with its MoE capacity factor set (None: ``cfg``)."""
    if moe_capacity is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(moe_capacity)))


def engine_passes(rank, world, case):
    """``Engine(mesh=)``'s four passes on ``case`` (arch, numpy params and
    batch, clip, MoE capacity) over a (world, 1) host mesh; every result as
    numpy, gradients in the reference's layout."""
    spec = registry.get(case["arch"])
    cfg = edit_cfg(spec.smoke(), case.get("capacity"))
    params = interop.params_from_numpy(case["params"], device="cpu")
    batch = _torch_batch(case["batch"])
    mesh = make_host_mesh(device_type="cpu")
    dpex.check_replicated(params, mesh)
    eng = pex.Engine(pex.PexSpec(), mesh=mesh)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    n = eng.value_and_norms(loss_fn, params, batch)
    g = eng.value_grads_and_norms(loss_fn, params, batch)
    c = eng.clipped_step(loss_fn, params, batch, clip_norm=case["clip"])
    p = eng.step(loss_fn, params, batch,
                 [pex.Clip(case["clip"]), pex.GNS()])
    # dist.pex's functions on the explicit-accumulator loss
    acc_loss = eng._adapt(loss_fn, pex.ExampleLayout(eng.spec.n_groups))
    b = batch["ids"].shape[0]
    fn_n = dpex.value_and_norms(acc_loss, params, batch, eng.spec, b,
                                mesh=mesh)
    fn_g = dpex.value_grads_and_norms(acc_loss, params, batch, eng.spec, b,
                                      mesh=mesh)
    fn_c = dpex.clipped_value_and_grads(acc_loss, params, batch, eng.spec,
                                        b, case["clip"], mesh=mesh)
    return {
        "functions": {
            "norms": _np(fn_n.sq_norms), "grads": np_tree(fn_g.grads),
            "clipped": np_tree(fn_c.grads), "loss": _np(fn_g.loss),
            "gns": _np(dpex.gradient_noise_scale(fn_g.sq_norms,
                                                 fn_g.grads))},
        "norms": {"loss": _np(n.loss), "loss_vec": _np(n.loss_vec),
                  "sq_norms": _np(n.sq_norms)},
        "grads": {"loss": _np(g.loss), "loss_vec": _np(g.loss_vec),
                  "sq_norms": _np(g.sq_norms), "grads": np_tree(g.grads)},
        "clipped": {"loss": _np(c.loss), "sq_norms": _np(c.sq_norms),
                    "grads": np_tree(c.grads)},
        "plan": {"loss": _np(p.loss), "gns": _np(p.gns),
                 "weights": _np(p.weights), "clip_coef": _np(p.clip_coef),
                 "grads": np_tree(p.grads)},
    }


def _aux_loss(loss_fn):
    def with_aux(params, batch, tap):
        loss_vec, _ = loss_fn(params, batch, tap)
        return loss_vec, {"mean": loss_vec.mean()}
    return with_aux


def refusals(rank, world, case):
    """What each refused call raises on a world-2 host mesh: a model axis
    of extent 2, a loss with a non-empty aux, a batch of 7 and an
    importance k of 3 (8 examples over 2 shards)."""
    spec = registry.get(case["arch"])
    cfg = spec.smoke()
    params = interop.params_from_numpy(case["params"], device="cpu")
    batch = _torch_batch(case["batch"])
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec(), mesh=make_host_mesh(device_type="cpu"))
    mp_eng = pex.Engine(pex.PexSpec(), mesh=make_host_mesh(
        model_parallel=2, device_type="cpu"))
    seven = {k: v[:7] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    return {
        "model_axis": _raised(lambda: mp_eng.value_and_norms(
            loss_fn, params, batch)),
        "aux": _raised(lambda: eng.value_grads_and_norms(
            _aux_loss(loss_fn), params, batch)),
        "batch": _raised(lambda: eng.value_and_norms(loss_fn, params,
                                                     seven)),
        "importance_k": _raised(lambda: eng.step(
            loss_fn, params, batch, [pex.Importance(3, rng=gen),
                                     pex.Grads()])),
        "aux_local": _raised(lambda: pex.Engine(pex.PexSpec()).step(
            _aux_loss(loss_fn), params, batch, [pex.Grads()])),
    }


def several_data_axes(rank, world, case):
    """On a (2, 2, 1) ("pod", "data", "model") mesh with data_axes ("pod",
    "data"): the grads+norms pass and the [Clip, GNS] plan against the
    local Engine on this rank, and the mesh helpers on a real mesh."""
    spec = registry.get(case["arch"])
    cfg = spec.smoke()
    params = interop.params_from_numpy(case["params"], device="cpu")
    batch = _torch_batch(case["batch"])
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    axes = ("pod", "data", "model")
    mesh = shd.make_mesh((2, 2, 1), axes, device_type="cpu")
    eng = pex.Engine(pex.PexSpec(), mesh=mesh, data_axes=("pod", "data"))
    local = pex.Engine(pex.PexSpec())
    cons = [pex.Clip(case["clip"]), pex.GNS()]
    out = {}
    for tag, e in (("mesh", eng), ("local", local)):
        g = e.value_grads_and_norms(loss_fn, params, batch)
        p = e.step(loss_fn, params, batch, cons)
        out[tag] = {"loss": _np(g.loss), "loss_vec": _np(g.loss_vec),
                    "sq_norms": _np(g.sq_norms), "grads": np_tree(g.grads),
                    "gns": _np(p.gns), "plan": np_tree(p.grads)}
    shards = dpex.data_shards(mesh, ("pod", "data"))
    with shd.use_rules(mesh, {"batch": ("pod", "data"), "mlp": "model"}):
        placements = [(type(p).__name__, getattr(p, "dim", None)) for p in
                      shd.sharding_for(("batch", None, "mlp")).placements]
        tree = shd.sharding_tree({"w": ("mlp", None), "b": [("batch",)]})
    sub = shd.make_mesh_over([0, 1], (2, 1), ("data", "model"),
                             device_type="cpu")
    out["mesh"].update(
        shard=(shards.index, shards.count),
        local_batch=shd.local_batch(8, ("pod", "data"), mesh),
        axis_size=shd.axis_size(("pod", "data", "model"), mesh),
        placements=placements,
        tree=sorted(tree) + [len(tree["b"])],
        sub_coordinate=None if sub.get_coordinate() is None
        else list(sub.get_coordinate()),
        production=_raised(lambda: make_production_mesh(device_type="cpu")),
        over_too_few=_raised(lambda: shd.make_mesh_over(
            [0, 1, 2], (2, 2), ("data", "model"), device_type="cpu")))
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _injecting(noise=None, indices=None):
    """Replace the port's two draw sites by the reference's draws, in
    order (``passes._standard_normal``, ``importance._choice``)."""
    noise = list(noise or [])
    indices = list(indices or [])
    if noise:
        def normal(shape, generator, device):
            d = torch.tensor(noise.pop(0))      # a copy: the add scales it
            assert tuple(d.shape) == tuple(shape)
            return d
        passes._standard_normal = normal
    if indices:
        timp._choice = lambda gen, p, k, replace: torch.as_tensor(
            indices.pop(0))
    return noise, indices


def _trainer(case, consumers, mesh, **kw):
    spec = registry.get(case["arch"])
    cfg = spec.smoke()
    return ttrainer.Trainer(
        registry.make_loss_fn_v2(spec, cfg),
        interop.params_from_numpy(case["params"], device="cpu"),
        pex.PexSpec(),
        adamw.AdamWConfig(lr=case["lr"], schedule=tsched.linear_warmup_cosine(
            3, case["steps"])),
        ttrainer.TrainConfig(consumers=consumers, steps=case["steps"],
                             log_every=0, **kw),
        tpipe.DataConfig(**case["data"]), mesh=mesh, device="cpu")


def trainer_runs(rank, world, case):
    """On a (world, 1) host mesh: the clip+noise and importance trainers
    with the reference's draws injected, then the clip+noise trainer with
    the port's own draws and ``compress_grads`` (its error buffers). The
    metrics and final parameters of each run."""
    mesh = make_host_mesh(device_type="cpu")
    out = {}
    runs = (("clip_noise", ttrainer.consumers_for_mode(
                "clip", case["data"]["global_batch"], clip_norm=1.0,
                noise_std=case["noise_std"]), {}, case["noise"], None),
            ("importance", ttrainer.consumers_for_mode(
                "importance", case["data"]["global_batch"]), {}, None,
             case["indices"]),
            ("own_compress", ttrainer.consumers_for_mode(
                "clip", case["data"]["global_batch"], clip_norm=1.0,
                noise_std=case["noise_std"]), {"compress_grads": True},
             None, None))
    saved = passes._standard_normal, timp._choice
    for tag, consumers, kw, noise, indices in runs:
        left = _injecting(noise, indices)
        try:
            t = _trainer(case, consumers, mesh, **kw)
            metrics = t.train()
        finally:
            passes._standard_normal, timp._choice = saved
        out[tag] = {"metrics": [{k: v for k, v in m.items()
                                 if k != "time_s"} for m in metrics],
                    "params": np_tree(t.params), "left": [len(x)
                                                          for x in left],
                    "err": None if t.err is None else np_tree(t.err)}
    t = _trainer(case, runs[0][1], None)
    t.rebind_mesh(mesh)
    out["rebound_engine_mesh"] = t.engine.mesh is mesh
    return out


# ---------------------------------------------------------------------------
# the tenant service (tests/test_torch_tenancy.py's problem)
# ---------------------------------------------------------------------------

D, O, R, S_TOK = 6, 4, 2, 5
ALPHA = 8.0
C, SIGMA, LR = 1.0, 0.3, 0.1
W_BASE = (0.3 * np.random.default_rng(0).standard_normal((D, O))).astype(
    np.float32)


def tenant_init(gen):
    return {"site": tlora.init_pair(gen, D, O, R, ALPHA, device=gen.device,
                                    b_std=0.4)}


def tenant_loss(adapters, data, tap):
    p = {"w": torch.as_tensor(W_BASE), "lora": adapters["site"]}
    z = linear(p, data["x"], tap=tap, group="all")
    tok = tap.token_loss(torch.sum(torch.square(z - data["y"]), dim=-1))
    return torch.sum(tok, dim=1), {}


def tenant_steps(rank, world, case):
    """One ``TenantService(mesh=)`` step per granularity from the
    reference's store rows with its per-tenant draws injected, and one with
    the port's own draws beside the single-tenant oracle engines (run on
    every rank, on the whole batch)."""
    mesh = shd.make_mesh((world,), ("data",), device_type="cpu")
    x, y, owner = case["x"], case["y"], case["owner"]
    tenants = np.unique(owner)
    out = {}
    saved = passes._standard_normal
    for gran in ("example", "token"):
        store = AdapterStore(tenant_init, capacity=128, seed=7,
                             device="cpu")
        for t in tenants:
            store.admit(int(t))
        store.scatter(tenants, interop.params_from_numpy(case["rows"],
                                                         device="cpu"))
        left, _ = _injecting(case["draws"])
        try:
            svc = TenantService(store, tenant_loss, clip_norm=C,
                                noise_std=SIGMA, noise_scale=C, lr=LR,
                                mesh=mesh, granularity=gran)
            res = svc.step({"x": torch.as_tensor(x), "y": torch.as_tensor(y)},
                           owner, rng=torch.Generator().manual_seed(1))
        finally:
            passes._standard_normal = saved
        rows = store.gather(tenants)["site"]
        out[gran] = {"left": len(left), "tenant_ids": res.tenant_ids,
                     "tenant_count": res.tenant_count.numpy(),
                     "sq_norms": _np(res.sq_norms),
                     "clip_coef": _np(res.clip_coef),
                     "loss_vec": _np(res.loss_vec),
                     "tenant_loss": _np(res.tenant_loss),
                     "tenant_clip_mean": _np(res.tenant_clip_mean),
                     "tenant_clip_min": _np(res.tenant_clip_min),
                     "a": _np(rows.a), "b": _np(rows.b)}
    out["oracle"] = _tenant_oracle(mesh, case["ox"], case["oy"],
                                   case["oowner"])
    return out


def _tenant_oracle(mesh, x, y, owner):
    """The port's own draws: the mesh service step beside one
    single-tenant Engine step per tenant; (got, want) pairs of each
    tenant's norms, clip coefficients and updated rows."""
    store = AdapterStore(tenant_init, capacity=32, seed=4, device="cpu")
    svc = TenantService(store, tenant_loss, clip_norm=C, noise_std=SIGMA,
                        noise_scale=C, lr=LR, mesh=mesh)
    batch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
    res = svc.step(batch, owner, rng=torch.Generator().manual_seed(99))
    seed = passes.step_seed(torch.Generator().manual_seed(99))
    tb = assemble(batch, owner)
    oracle = pex.Engine(pex.PexSpec())
    pairs = []
    for t in tb.unique_tenants:
        at = tenant_init(torch.Generator().manual_seed(pm.fold_seed(4,
                                                                    int(t))))
        idx = np.flatnonzero(owner == t)
        r_t = oracle.step(
            tenant_loss, at, {"x": torch.as_tensor(x[idx]),
                              "y": torch.as_tensor(y[idx])},
            [pex.Clip(C), pex.Noise(SIGMA, passes.tenant_generator(
                seed, int(t), torch.device("cpu")), scale=C)])
        pos = np.flatnonzero(tb.tenant_ids == t)
        new = pm.tree_map(lambda a, g: a - LR * g, at, r_t.grads)
        got = store.gather([t])["site"]
        pairs += [(_np(g), _np(w)) for g, w in (
            (res.sq_norms[pos].sum(-1), r_t.sq_norms.sum(-1)),
            (res.clip_coef[pos], r_t.clip_coef),
            (got.a[0], new["site"].a), (got.b[0], new["site"].b))]
    return pairs


def jobs(rank, world, todo):
    """Several jobs in one group: ``{name: fn(rank, world, case)}`` for
    each ``(name, fn, case)`` of ``todo``, in order."""
    return {name: fn(rank, world, case) for name, fn, case in todo}
