"""The port's span recorder (``repro_torch.spans``) on the CPU.

Off, a step is bit for bit the step recorded, and the recorder makes no
CUDA event and calls no ``record_function``. On, a DP-SGD step of the
llama3.2-1b smoke config (remat ``full``) records the training step's
span tree with its parents and step numbers, a plain step has no norms
or noise span, every span lies on a CPU profiler's timeline as a user
annotation inside its parent's, and the MoE counters equal a hand count
of the same routing, once per layer's forward under remat. An exception
inside a recording turns the recorder off.
"""
import dataclasses

import pytest
import torch

from repro_torch import spans
from repro_torch.core import plan as tplan
from repro_torch.core.taps import NULL, PexSpec
from repro_torch.data import pipeline as tpipe
from repro_torch.models import registry
from repro_torch.nn import moe as tmoe
from repro_torch.nn.linear import linear
from repro_torch.nn.param import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train import trainer as ttrainer

B, S = 4, 16
DP = (tplan.Norms(), tplan.Clip(1.0), tplan.Noise(1.0))
PLAIN = (tplan.Grads(),)


def _trainer(consumers, arch="llama3.2-1b"):
    spec = registry.get(arch)
    cfg = spec.smoke()
    assert cfg.remat and cfg.remat_policy == "full"
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    return ttrainer.Trainer(
        registry.make_loss_fn_v2(spec, cfg), params, PexSpec(),
        adamw.AdamWConfig(lr=1e-3),
        ttrainer.TrainConfig(consumers=consumers, steps=2, log_every=0),
        tpipe.DataConfig(vocab=cfg.vocab, seq=S, global_batch=B),
        device="cpu"), cfg


def _steps(tr, n=2):
    out = []
    for _ in range(n):
        out.append(tr.run_step(tr.data.batch_at(tr.step)))
        tr.step += 1
    return out


def _tree(rec):
    """(name, parent's name, step) of every span, in the order opened."""
    by = {s.id: s for s in rec.spans}
    return [(s.name, None if s.parent is None else by[s.parent].name,
             s.step) for s in rec.spans]


@pytest.mark.parametrize("consumers", [DP, PLAIN], ids=["dpsgd", "plain"])
def test_off_is_bit_for_bit_on_and_touches_no_event(consumers, monkeypatch):
    on, _ = _trainer(consumers)
    with spans.recording("cpu") as rec:
        got_on = _steps(on)
    assert rec.spans

    def refuse(*a, **k):
        raise AssertionError("the recorder is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off, _ = _trainer(consumers)
    assert not spans.active()
    assert spans.span("a") is spans.span("b")
    got_off = _steps(off)
    assert got_on == [dict(m, time_s=o["time_s"])
                      for m, o in zip(got_off, got_on)]
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)


def test_a_dp_step_records_the_step_tree():
    tr, cfg = _trainer(DP)
    tr.step = 7
    with spans.recording("cpu") as rec:
        tr.run_step(tr.data.batch_at(tr.step))
    remat = [("remat.recompute", None, 7)] * cfg.n_layers

    def under(parent, names):
        return [(n, parent, s) for n, _, s in names]
    want = ([("trainer.step", None, 7),
             ("trainer.read", "trainer.step", 7),      # the noise seed
             ("engine.step", "trainer.step", 7),
             ("plan.forward", "engine.step", 7),
             ("plan.backward.norms", "engine.step", 7)]
            + under("plan.backward.norms", remat)
            + [("plan.backward.grads", "engine.step", 7)]
            + under("plan.backward.grads", remat)
            + [("plan.noise", "engine.step", 7),
               ("trainer.read", "trainer.step", 7),    # the loss
               ("trainer.read", "trainer.step", 7),    # finite norms
               ("adamw.update", "trainer.step", 7),
               ("trainer.read", "trainer.step", 7),    # norm_mean
               ("trainer.read", "trainer.step", 7)])   # norm_max
    assert _tree(rec) == want
    assert [s.id for s in rec.spans] == list(range(len(want)))
    for s in rec.spans:
        assert s.host_end_ns >= s.host_start_ns and s.device_ms is None
    assert rec.counters == {}


def test_a_plain_step_has_no_norms_or_noise_span():
    tr, cfg = _trainer(PLAIN)
    with spans.recording("cpu") as rec:
        _steps(tr)
    names = [n for n, _, _ in _tree(rec)]
    assert "plan.backward.norms" not in names and "plan.noise" not in names
    assert names.count("trainer.step") == 2
    assert names.count("plan.backward.grads") == 2
    assert names.count("remat.recompute") == 2 * cfg.n_layers
    assert [s.step for s in rec.named("engine.step")] == [0, 1]


def test_spans_lie_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile
    tr, _ = _trainer(DP)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            spans.recording("cpu", timed=False) as rec:
        tr.run_step(tr.data.batch_at(0))
    marks = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if getattr(e, "is_user_annotation", False))
    by_name = {}
    for m in marks:
        by_name.setdefault(m[2], []).append(m)
    assert sorted(by_name) == sorted({s.name for s in rec.spans})
    mark_of = {}
    for name, got in by_name.items():
        opened = rec.named(name)
        assert len(got) == len(opened), name
        mark_of.update({s.id: m for s, m in zip(opened, got)})
    for s in rec.spans:
        if s.parent is not None:
            (a, b, _), (pa, pb, _) = mark_of[s.id], mark_of[s.parent]
            assert pa <= a and b <= pb, (s.name, rec.spans[s.parent].name)


def test_moe_counters_are_a_hand_count_of_the_routing():
    cfg = tmoe.MoeCfg(d_model=16, d_ff=24, n_experts=4, top_k=2,
                      capacity_factor=0.5, renorm_topk=True,
                      dispatch_groups=2)
    p = tmoe.init_moe(torch.Generator().manual_seed(3), cfg,
                      dtype=torch.float32, device="cpu")
    x = torch.randn(B, S, 16, generator=torch.Generator().manual_seed(4))
    with spans.recording("cpu") as rec:
        tmoe.moe(p, x, tap=NULL, cfg=cfg)
    ng, tg = 2, B * S // 2
    cap = cfg.capacity(tg)
    logits = linear(p["router"], x.to(torch.float32), tap=NULL)
    _, eidx = tmoe._route(cfg, logits.reshape(B * S, -1))
    counts = [torch.bincount(g, minlength=4) for g in eidx.reshape(ng, -1)]
    filled = sum(int(torch.clamp(c, max=cap).sum()) for c in counts)
    assert filled < B * S * 2          # capacity drops some assignments
    assert rec.counters == {"moe.slots": ng * 4 * cap, "moe.filled": filled,
                            "moe.assignments": B * S * 2}


def test_moe_counts_once_per_forward_under_remat():
    tr, cfg = _trainer(DP, arch="phi3.5-moe")
    with spans.recording("cpu") as rec:
        tr.run_step(tr.data.batch_at(0))
    moe = cfg.moe
    ng = moe.dispatch_groups
    cap = moe.capacity(B * S // ng)
    assert len(rec.named("remat.recompute")) == 2 * cfg.n_layers
    assert rec.counters["moe.slots"] == \
        cfg.n_layers * ng * moe.n_experts * cap
    assert rec.counters["moe.assignments"] == cfg.n_layers * B * S * moe.top_k
    assert 0 < rec.counters["moe.filled"] <= rec.counters["moe.assignments"]


def test_counters_add_numbers_and_tensors():
    with spans.recording("cpu") as rec:
        spans.count("n", 2)
        spans.count("n", torch.tensor(3))
        spans.count("x", 0.5)
    spans.count("n", 100)
    assert rec.counters == {"n": 5, "x": 0.5}


def test_an_exception_turns_the_recorder_off():
    with pytest.raises(ValueError, match="inside"):
        with spans.recording("cpu"):
            with spans.span("outer"):
                raise ValueError("inside")
    assert not spans.active()
    with spans.recording("cpu") as rec:
        with pytest.raises(RuntimeError, match="do not nest"):
            with spans.recording("cpu"):
                pass
        with spans.span("after"):
            pass
    assert [s.name for s in rec.spans] == ["after"]
    assert rec.spans[0].parent is None and not spans.active()


def test_a_span_keeps_the_launches_made_inside_it(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops.gram_norm, "launches", 0)
    with spans.recording("cpu") as rec:
        with spans.span("outer"):
            with spans.span("inner"):
                ops.gram_norm.launches += 2
    outer, inner = rec.spans
    assert inner.launches == outer.launches == {"gram_norm": 2}
    assert dataclasses.asdict(inner)["parent"] == outer.id
