"""The port's fault-tolerance host logic against the reference's.

``repro_torch.ft`` keeps its own copy of ``repro.ft``'s elastic planning,
heartbeats, fault plans and supervisor. The same inputs go through both
packages and every output must be equal: contraction and expansion plans
and their refusals, mesh shapes and host reassignment
(``tests/test_substrate.py``'s cases), heartbeat surveys with torn, empty,
misnamed and in-flight files, straggler detection on seeded step times,
the scripted storms and ``random_storm`` by seed (numpy's generator, so
the same events), plan validation, poison vectors, the checkpoint faults'
bytes, and the supervisor's event log and recovery calls in each of
``tests/test_soak.py``'s scenarios. The port's ``poison_loss_fn`` wraps a
torch loss: all-ones poison is the unwrapped loss bit for bit, and NaN
rows reach the ``Trainer``'s quarantine.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.ft import elastic as jel
from repro_torch import ft
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft import elastic as tel
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer


def _outcome(fn, *args, **kw):
    """``fn``'s result as plain data, or its exception's type and text."""
    try:
        out = fn(*args, **kw)
    except (RuntimeError, ValueError, AssertionError) as e:
        return ("raised", type(e).__name__, str(e))
    if dataclasses.is_dataclass(out):
        return dataclasses.astuple(out)
    return out


def test_ft_exports_match_reference():
    assert ft.__all__ == jft.__all__
    assert ft.inject.KINDS == jft.inject.KINDS


TOPOLOGIES = [(64, 4, 16), (16, 1, 8), (4, 4, 12), (4, 4, 16), (8, 2, 4),
              (4, 1, 1), (4, 1, 4), (3, 2, 2), (1, 1, 1)]


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_elastic_plans_match_reference(topo):
    jt, tt = jel.Topology(*topo), tel.Topology(*topo)
    assert tt.n_devices == jt.n_devices
    rs = np.random.default_rng(sum(topo))
    deads = [[], [0], list(range(topo[0] - 1)), list(range(topo[0]))]
    deads += [sorted(rs.choice(topo[0], k, replace=False).tolist())
              for k in range(1, topo[0])][:3]
    for dead in deads:
        assert _outcome(tel.plan_contraction, tt, dead) == \
            _outcome(jel.plan_contraction, jt, dead), dead
        hosts = list(range(topo[0]))
        for k in (0, 1, 2, topo[0]):
            assert tel.reassign_data_hosts(hosts, dead, k) == \
                jel.reassign_data_hosts(hosts, dead, k)
    for pool in range(0, 2 * topo[0] + 2):
        assert _outcome(tel.plan_expansion, tt, pool) == \
            _outcome(jel.plan_expansion, jt, pool), pool
    for multi in (False, True):
        assert _outcome(tel.mesh_shape, tt, multi) == \
            _outcome(jel.mesh_shape, jt, multi)


def _heartbeat_dirs(tmp_path):
    """One heartbeat directory per package, with the same committed beats
    and the same junk: torn, empty, misnamed and in-flight files."""
    out = []
    for mod, name in ((jft, "jax"), (ft, "torch")):
        d = tmp_path / name
        cfg = mod.HeartbeatConfig(deadline_s=5.0)
        for h, t in ((0, 100.0), (3, 90.0), (5, 99.0)):
            mod.HeartbeatMonitor(str(d), h, cfg).beat(step=h, now=t)
        (d / "host_00001.json").write_text('{"step": 3, "ti')
        (d / "host_00002.json").write_text("")
        (d / "host_junk.json").write_text("{}")
        (d / "host_00004.json.tmp").write_text("{}")
        (d / "host_00006.json").write_text('{"step": 1}')
        out.append(mod.HeartbeatMonitor(str(d), 0, cfg))
    return out


def test_heartbeat_surveys_match_reference(tmp_path):
    jmon, tmon = _heartbeat_dirs(tmp_path)
    for now in (100.0, 101.0, 104.9, 106.0, 200.0):
        assert tmon.survey(now=now) == jmon.survey(now=now)
        assert tmon.dead_hosts(now=now) == jmon.dead_hosts(now=now)
    assert tmon.dead_hosts(now=101.0) == [1, 2, 3, 6]


def test_straggler_detection_matches_reference():
    rs = np.random.default_rng(5)
    cases = [{i: 1.0 for i in range(8)}, {0: 1.0, 1: 1.01},
             {0: 1.0, 1: 1.0, 2: 1.0, 3: 8.0}]
    for n in (3, 4, 5, 8, 16):
        for _ in range(4):
            t = rs.lognormal(0.0, 0.3, n)
            t[rs.integers(n)] *= rs.uniform(1.0, 6.0)
            cases.append({i: float(x) for i, x in enumerate(t)})
    for times in cases:
        for mad in (1.0, 3.0):
            assert ft.detect_stragglers(times, mad) == \
                jft.detect_stragglers(times, mad)


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


@pytest.mark.parametrize("hosts,steps", [(4, 24), (8, 40), (16, 64)])
def test_storms_match_reference(hosts, steps):
    assert _events(ft.scripted_storm("short", hosts, steps)) == \
        _events(jft.scripted_storm("short", hosts, steps))
    assert _events(ft.scripted_storm("none", hosts, steps)) == []
    for seed in range(12):
        for kw in ({}, {"p_kill": 0.3, "p_ckpt": 0.2, "p_nan": 0.3,
                        "max_kills": hosts - 1}):
            t = ft.random_storm(seed, hosts, steps, **kw)
            assert _events(t) == _events(jft.random_storm(seed, hosts,
                                                          steps, **kw))
            j = jft.random_storm(seed, hosts, steps, **kw)
            b = 2 * hosts
            for step in range(steps):
                np.testing.assert_array_equal(t.poison_vector(step, b),
                                              j.poison_vector(step, b))
                assert [dataclasses.astuple(e) for e in t.at_tick(step)] \
                    == [dataclasses.astuple(e) for e in j.at_tick(step)]
                for h in range(hosts):
                    assert t.straggler_factor(step, h) == \
                        j.straggler_factor(step, h)


def test_fault_plan_refusals_match_reference():
    cases = [
        lambda m: m.FaultPlan((m.FaultEvent(1, "host_death", host=0),
                               m.FaultEvent(2, "host_death", host=0))
                              ).validate(4, 10),
        lambda m: m.FaultPlan((m.FaultEvent(1, "host_death", host=9),)
                              ).validate(4, 10),
        lambda m: m.FaultEvent(1, "meteor_strike"),
        lambda m: m.FaultEvent(-1, "host_death"),
        lambda m: m.scripted_storm("short", 3, 40),
        lambda m: m.scripted_storm("short", 8, 10),
        lambda m: m.scripted_storm("long", 8, 40),
        lambda m: m.FaultPlan((m.FaultEvent(5, "nan_batch",
                                            examples=(1, 7)),)
                              ).poison_vector(5, 6),
    ]
    for case in cases:
        got, want = _outcome(case, ft), _outcome(case, jft)
        assert got[0] == "raised" and got == want
    plan = ft.FaultPlan((ft.FaultEvent(5, "nan_batch", examples=(1, 3)),))
    v = plan.poison_vector(5, 6)
    assert np.isnan(v[[1, 3]]).all() and np.isfinite(v[[0, 2, 4, 5]]).all()
    assert (plan.poison_vector(4, 6) == 1.0).all()


@pytest.mark.parametrize("truncate", [False, True])
def test_checkpoint_faults_match_reference(tmp_path, truncate):
    """The same committed step dirs, hit by each package's fault: the
    same step, the same bytes after; ``litter_tmp_dir`` leaves the same
    torn manifest; an empty directory has nothing to corrupt."""
    src = tmp_path / "src"
    for step in (3, 6):
        d = src / f"step_{step:09d}"
        d.mkdir(parents=True)
        (d / "shard_00000.npz").write_bytes(bytes(range(256)) * 3)
        (d / "manifest.json").write_text("{}")
    (src / "step_000000009.tmp").mkdir()
    out = {}
    for mod, name in ((jft, "jax"), (ft, "torch")):
        d = tmp_path / name
        shutil.copytree(src, d)
        step = mod.corrupt_newest_checkpoint(str(d), truncate=truncate)
        path = mod.litter_tmp_dir(str(d), 12)
        out[name] = (step, os.path.basename(path), {
            os.path.relpath(os.path.join(r, f), d):
                open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(d) for f in fs})
        (tmp_path / f"{name}_empty").mkdir()
        assert mod.corrupt_newest_checkpoint(
            str(tmp_path / f"{name}_empty")) is None
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 6


# --- the supervisor -----------------------------------------------------------

class _Recorder:
    """A RecoveryActions for either package: records each call; fails on
    demand."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def restore_to(self, topology, active_hosts, reason):
        if self.fail:
            raise RuntimeError("restore failed")
        self.calls.append((reason, topology.n_hosts, list(active_hosts)))


def _scenario(mod, d, name):
    """Drive one of ``tests/test_soak.py``'s supervisor scenarios through
    ``mod``'s supervisor; return its event log, calls, state and active
    set, or the halt."""
    cfg = mod.HeartbeatConfig(interval_s=1.0, deadline_s=2.5)
    n = 4
    mons = {h: mod.HeartbeatMonitor(str(d), h, cfg) for h in range(n)}
    sup_mon = mod.HeartbeatMonitor(str(d), n, cfg)
    rec = _Recorder(fail=name == "recovery_fails")
    topo = mod.Topology(2, 1, 1) if name == "expand" else \
        mod.Topology(4, 1, 4 if name == "floor" else 1)
    sup_cfg = mod.SupervisorConfig(straggler_grace=3,
                                   allow_expansion=name != "straggler")
    sup = mod.Supervisor(topo, list(range(topo.n_hosts)), sup_mon, rec,
                         sup_cfg)
    halts = []
    slow = {0: 1.0, 1: 1.0, 2: 1.0, 3: 8.0}
    schedule = {
        "dead": [(0.0, (0, 1, 3), None), (1.0, (0, 1), None)],
        "torn": [(0.0, (0, 1, 2, 3), None), (0.5, "torn", None)],
        "straggler": [(t, (0, 1, 2, 3), times) for t, times in
                      ((0.0, slow), (1.0, slow),
                       (2.0, {h: 1.0 for h in range(4)}), (3.0, slow),
                       (4.0, slow), (5.0, slow))],
        "expand": [(0.0, (0, 1, 2, 3), None)],
        "floor": [(0.0, (0,), None), (1.0, (0,), None)],
        "recovery_fails": [(0.0, (0, 1, 2), None)],
    }[name]
    for now, beats, times in schedule:
        if beats == "torn":
            (d / "host_00003.json").write_text('{"to')
        else:
            for h in beats:
                mons[h].beat(step=0, now=now)
        try:
            sup.tick(now, step_times=times)
        except mod.SupervisorHalted as e:
            halts.append(str(e))
    return ([(e.now, e.kind, e.detail) for e in sup.events], rec.calls,
            sup.state, sup.active, dataclasses.astuple(sup.topo), halts)


@pytest.mark.parametrize("name", ["dead", "torn", "straggler", "expand",
                                  "floor", "recovery_fails"])
def test_supervisor_event_logs_match_reference(tmp_path, name):
    want = _scenario(jft, tmp_path / "jax", name)
    got = _scenario(ft, tmp_path / "torch", name)
    assert got == want
    assert got[0], "the scenario produced no event"


# --- poison --------------------------------------------------------------------

def test_poison_loss_fn_is_identity_and_reaches_quarantine():
    """All-ones poison gives the unwrapped loss bit for bit, through the
    Engine on the llama3.2-1b smoke config; a NaN row is quarantined by
    the Trainer by name, and the step trains on the rest."""
    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)

    def trainer(fn):
        return Trainer(fn, params, PexSpec(), adamw.AdamWConfig(lr=1e-3),
                       TrainConfig(steps=1, log_every=0),
                       DataConfig(vocab=cfg.vocab, seq=8, global_batch=4),
                       device="cpu")

    plain, poisoned = trainer(loss_fn), trainer(ft.poison_loss_fn(loss_fn))
    batch = plain.data.batch_at(0)
    want = plain.engine.step(loss_fn, params, batch, plain.consumers)
    got = poisoned.engine.step(
        poisoned.loss_fn, params, dict(batch, poison=torch.ones(4)),
        poisoned.consumers)
    assert torch.equal(got.loss_vec, want.loss_vec)
    assert torch.equal(got.sq_norms, want.sq_norms)
    plan = ft.FaultPlan((ft.FaultEvent(0, "nan_batch", examples=(2,)),))
    m = poisoned.run_step(dict(batch, poison=torch.as_tensor(
        plan.poison_vector(0, 4))))
    assert poisoned.events == [{"step": 0, "kind": "quarantine",
                                "examples": [2]}]
    assert m["quarantined"] == 1 and np.isfinite(m["loss"])
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(poisoned.params))
