"""The cost side of the port's static analysis (``repro_torch.analysis``
traffic, cost, plan invariants) on the CPU at smoke configs.

  * Traffic against the reference's ``analysis.traffic`` on llama3.2-1b
    and phi3.5-moe (f32 smoke, B=3, S=8, the DP consumers under AdamW):
    the gradient leaves (the reference's stacked leaves split per layer by
    ``interop``), the plan's description, the phases present, and the
    contractions' flops by phase — equal in the forward phase and within 1%
    in each backward phase. What is the same by construction is compared:
    both packages without remat, and llama3.2-1b with each package's
    default remat (``full``: the recompute charged to the backward that
    demands it, the port's dead tail skipped as the reference's DCE drops
    it); the reference's per-example stat contractions (batched over B with
    rank-3 operands, the XLA forms of the norms) are left out, where the
    port records a kernel site instead. Bytes are not compared (eager
    against fused, by design); they are pinned on a toy program counted by
    hand.
  * The reference's ``tests/test_pexcost.py`` cases in the port: the
    allowlisted apply streams, the roofline arithmetic on the H100
    profile, the collective term, contracts composed, the JSON round trip,
    the profile registry, the baseline gate, the committed baseline equal
    to head, ``Plan.static_cost``.
  * The mutants of ``tests/test_pexcost_mutation.py`` rebuilt in the port,
    each caught by its own finding through ``Engine.verify(cost=True)``,
    and one through the CLI gate.
  * The plan invariants on recorded programs.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.analysis import _jaxpr as jjaxpr
from repro.analysis import traffic as jtraffic
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.analysis import _trace
from repro_torch.analysis import cost as cost_mod
from repro_torch.analysis import plan_invariants as pi
from repro_torch.analysis import traffic
from repro_torch.analysis.__main__ import lint_config, main as lint_main
from repro_torch.analysis.findings import ERROR, WARNING
from repro_torch.core import plan as plan_mod
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.roofline import constants as hw

PARITY_ARCHS = ("llama3.2-1b", "phi3.5-moe")
#: (arch, remat in both packages) of the traffic parity cases
PARITY = {"llama3.2-1b": ("llama3.2-1b", False),
          "phi3.5-moe": ("phi3.5-moe", False),
          "llama3.2-1b-remat": ("llama3.2-1b", True)}


def _dp(granularity="example"):
    g = torch.Generator().manual_seed(0)
    if granularity == "token":
        return [pex.Clip(1.0, granularity="token"),
                pex.Noise(0.1, g, scale=1.0)]
    return [pex.Clip(1.0), pex.Noise(0.1, g), pex.GNS()]


def _setup(arch="llama3.2-1b", remat=True):
    spec, cfg, loss_fn, params, batch = lint_config(arch)
    if not remat:
        loss_fn = registry.make_loss_fn_v2(
            spec, dataclasses.replace(cfg, remat=False))
    return loss_fn, params, batch


@pytest.fixture(scope="module")
def llama_traffic():
    loss_fn, params, batch = _setup()
    return traffic.check_train_step(loss_fn, params, batch, _dp())


# ---------------------------------------------------------------------------
# traffic against the reference
# ---------------------------------------------------------------------------

def _is_stat_form(rec) -> bool:
    """A reference contraction batched over the examples with rank-3
    operands: the XLA form of a per-example norm."""
    (_, _), (lb, rb) = rec.eqn.params["dimension_numbers"]
    a, b = rec.eqn.invars[0].aval, rec.eqn.invars[1].aval
    return tuple(lb) == (0,) and tuple(rb) == (0,) \
        and len(a.shape) == 3 and len(b.shape) == 3


def _reference(arch, remat=False):
    """The reference's traffic report, its contraction flops by phase
    (stat forms left out) and its parameter tree, with or without its
    default remat."""
    aspec = jreg.get(arch)
    cfg = dataclasses.replace(aspec.smoke(), remat=remat)
    mod = jreg.family_module(aspec)
    params = jax.eval_shape(lambda: unbox(mod.init(jax.random.PRNGKey(0),
                                                   cfg)))
    batch = jreg.train_batch_specs(aspec, cfg, JShape("lint", "train", 8, 3))
    tt = jjaxpr.trace_train_step(
        jreg.make_loss_fn_v2(aspec, cfg), params, batch,
        [jpex.Clip(1.0), jpex.Noise(0.1, jax.random.PRNGKey(0)),
         jpex.GNS()])
    rep = jtraffic.analyze_trace(tt)
    jaxpr = jtraffic.dce(tt.closed)
    taints = [jtraffic.EMPTY] * len(jaxpr.invars)
    for pos, tok in ((tt.param_positions, jtraffic.T_PARAM),
                     (tt.opt_positions, jtraffic.T_OPT),
                     (tt.batch_positions, jtraffic.T_BATCH),
                     (tt.rng_positions, jtraffic.T_KEY)):
        for i in pos:
            taints[i] = frozenset({tok})
    recs = jtraffic._walk(jaxpr, taints).records
    jtraffic._build_graph(recs)
    groups = jtraffic._needed_by(recs, jjaxpr.as_open(jaxpr).outvars,
                                 tt.out_labels)
    stat_elems = tt.batch_size * max(tt.seq or 1, 64)
    flops = {}
    for r in recs:
        r.phase = jtraffic._phase(r, tt.batch_size, stat_elems, groups)
        if r.name == "dot_general" and not _is_stat_form(r):
            flops[r.phase] = flops.get(r.phase, 0.0) + r.flops * r.trips
    return rep, flops, params


@pytest.fixture(scope="module", params=list(PARITY))
def parity(request):
    arch, remat = PARITY[request.param]
    rep, flops, jparams = _reference(arch, remat)
    loss_fn, params, batch = _setup(arch, remat)
    return arch, rep, flops, jparams, traffic.check_train_step(
        loss_fn, params, batch, _dp())


def test_traffic_leaves_plan_and_phases_match_reference(parity):
    arch, ref, _, jparams, port = parity
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jparams)
    split = interop.params_from_numpy(zeros, device="cpu")
    assert ref.n_leaves == len(jax.tree_util.tree_leaves(jparams))
    assert port.n_leaves == len(tree_leaves(split))
    assert port.plan_desc == ref.plan_desc
    present = {k for k, v in port.phase_bytes if v}
    assert present == {k for k, v in ref.phase_bytes if v}
    assert present == set(traffic.PHASES)


def test_traffic_contraction_flops_match_reference(parity):
    arch, _, ref, _, port = parity
    got = dict(port.phase_contraction_flops)
    assert got[traffic.PH_FWD] == ref[traffic.PH_FWD]
    for ph in (traffic.PH_ACT, traffic.PH_WEIGHT):
        assert got[ph] == pytest.approx(ref[ph], rel=0.01), (arch, ph)


# ---------------------------------------------------------------------------
# bytes and flops, counted by hand
# ---------------------------------------------------------------------------

def test_bytes_and_flops_of_a_toy_program_counted_by_hand():
    """One layer in f32: mm, a broadcast bias add, relu, a view, a sum, an
    in-place update, and a gram kernel site at its contract."""
    m, k, n = 6, 5, 4

    def prog(x, w, b):
        y = x @ w                       # mm
        z = torch.relu(y + b)           # add (b broadcast), relu
        s = z.view(-1).sum()            # view (0 B), sum
        w.add_(1.0)                     # in place: reads and writes w
        h = x.view(2, 3, k)
        ops.gram_norm(h, z.view(2, 3, n))
        return s

    tr = _trace.record_program(prog, torch.zeros(m, k), torch.zeros(k, n),
                               torch.zeros(n))
    f, b = traffic.program_cost(tr)
    mk, kn, mn = 4 * m * k, 4 * k * n, 4 * m * n
    want_b = ((mk + kn + mn)                 # mm
              + (mn + 4 * n + mn)            # y + b
              + (mn + mn)                    # relu
              + (mn + 4)                     # sum
              + (kn + kn)                    # w.add_
              + 2 * (3 * (k + n) * 4 + 4))   # gram: rows kept + norms
    want_f = (2 * m * k * n + mn // 4 + mn // 4 + mn // 4 + kn // 4
              + ops.flop_estimate(2, 3, k, n))
    assert b == want_b
    assert f == want_f
    (site,) = tr.of_kind("kernel")
    (c,) = traffic.kernel_contracts(site)
    assert c.hbm_bytes() == ops.norm_bytes(2, 3, k, n, torch.float32)


def test_write_only_and_indexed_in_place_ops_counted_by_hand():
    """``zero_`` and ``copy_`` write their target without reading it;
    ``index_add_`` and ``index_put_`` read and write only the rows their
    index reaches, not the whole table (an embedding gradient's case)."""
    v, d, r = 50, 8, 3

    def prog(t, src, idx, rows):
        t.zero_()
        t.copy_(src)
        t.index_add_(0, idx, rows)
        t.index_put_((idx,), rows, accumulate=True)

    tr = _trace.record_program(prog, torch.zeros(v, d), torch.zeros(v, d),
                               torch.zeros(r, dtype=torch.long),
                               torch.zeros(r, d))
    _, b = traffic.program_cost(tr)
    vd, rd, ri = 4 * v * d, 4 * r * d, 8 * r
    want = (vd                            # zero_: writes t
            + vd + vd                     # copy_: reads src, writes t
            + 2 * (ri + rd + 2 * rd))     # index_add_, index_put_: the
    assert b == want                      # index, the rows, r rows of t


# ---------------------------------------------------------------------------
# gradient streams and phases (tests/test_pexcost.py's cases)
# ---------------------------------------------------------------------------

def test_dp_step_streams_are_counted_and_allowlisted(llama_traffic):
    """The eager apply streams each gradient 18×: 15 AdamW ops, 2 for the
    global-norm clip, 1 for the noise add — allowlisted, citing the fused
    apply of ROADMAP.md Queue 2b row 0."""
    rep = llama_traffic
    assert rep.n_streams == rep.expected_streams == 18
    assert rep.ok and not rep.findings, rep.summary()
    (f,) = rep.allowlisted
    assert f.code == "redundant-hbm-stream"
    assert "ROADMAP.md Queue 2b row 0" in f.message and "18" in f.message


def test_strict_mode_moves_known_streams_into_findings():
    loss_fn, params, batch = _setup()
    rep = traffic.check_train_step(loss_fn, params, batch, _dp(),
                                   allow_known_streams=False)
    assert not rep.ok
    assert any(f.code == "redundant-hbm-stream" and f.severity == ERROR
               for f in rep.findings)


def test_chunked_update_is_one_stream_per_op(monkeypatch):
    """AdamW over 2^26-element chunks: a loop over one leaf's chunks is
    one stream, so chunks of 1000 elements (up to 9 a leaf here) leave the
    count as it was."""
    monkeypatch.setattr(adamw, "CHUNK", 1000)
    loss_fn, params, batch = _setup()
    rep = traffic.check_train_step(loss_fn, params, batch, _dp())
    assert rep.n_streams == rep.expected_streams == 18


def test_adafactor_streams_are_its_own():
    loss_fn, params, batch = _setup()
    rep = traffic.check_train_step(loss_fn, params, batch, _dp(),
                                   optimizer="adafactor")
    assert rep.optimizer == "adafactor"
    assert rep.n_streams == rep.expected_streams == 13 + 1
    assert rep.ok, rep.summary()


def test_norms_only_step_has_no_apply_traffic():
    loss_fn, params, batch = _setup()
    rep = traffic.check_train_step(loss_fn, params, batch, [pex.Norms()])
    assert rep.n_streams == 0 == rep.expected_streams
    assert rep.ok and not rep.allowlisted
    assert dict(rep.phase_bytes)[traffic.PH_APPLY] == 0.0


def test_phase_attribution_covers_the_step(llama_traffic):
    rep = llama_traffic
    by_phase = dict(rep.phase_bytes)
    for ph in (traffic.PH_FWD, traffic.PH_ACT, traffic.PH_WEIGHT,
               traffic.PH_STATS, traffic.PH_APPLY):
        assert by_phase[ph] > 0, ph
    assert sum(by_phase.values()) == pytest.approx(rep.hbm_bytes)
    # the reweighted backward reads the norms pass's residuals
    assert rep.residual_sharing == pytest.approx(1.0)
    assert rep.forward_flops <= 1.1 * rep.ref_forward_flops
    # the kernel sites (gram / direct of the norms pass) at their contracts
    assert 0 < rep.kernel_bytes < dict(rep.phase_bytes)[traffic.PH_STATS]


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-vl-7b"])
def test_cost_sweep_is_clean(arch):
    """Engine.verify(cost=True) at both granularities: no finding, the
    streams at the expectation, every CostReport on the H100 profile."""
    loss_fn, params, batch = _setup(arch)
    for gran in ("example", "token"):
        eng = pex.Engine(pex.PexSpec(), granularity=gran)
        rep = eng.verify(loss_fn, params, batch, [_dp(gran)],
                         allow=registry.untapped_allowlist(arch), seq=8,
                         deep=False, cost=True, model=arch)
        assert rep.ok and not rep.findings, rep.summary()
        (tr,) = rep.traffic
        assert tr.n_streams == tr.expected_streams, tr.summary()
        (cr,) = rep.cost
        assert cr.model == arch and cr.profile == hw.DEFAULT_PROFILE
        assert cr.t_step > 0 and cr.flops > 0 and cr.hbm_bytes > 0


# ---------------------------------------------------------------------------
# cost composition
# ---------------------------------------------------------------------------

def test_cost_report_roofline_arithmetic(llama_traffic):
    cr = cost_mod.build_cost(llama_traffic, model="llama3.2-1b")
    p = hw.get_profile(cr.profile)
    assert cr.profile == "h100-sxm-80gb"
    assert cr.t_compute == pytest.approx(cr.flops / 989e12)
    assert cr.t_memory == pytest.approx(cr.hbm_bytes / 3.35e12)
    assert cr.t_memory == pytest.approx(cr.hbm_bytes / p.hbm_bw)
    assert cr.t_collective == 0.0
    assert cr.t_step == max(cr.t_compute, cr.t_memory, cr.t_collective)
    assert cr.bottleneck == "memory"       # the smoke step is tiny
    assert cr.kernel_flops == llama_traffic.kernel_flops > 0


def test_cost_collective_term_scales_with_chips(llama_traffic):
    tr = dataclasses.replace(llama_traffic, coll_bytes=1e9)
    one = cost_mod.build_cost(tr, chips=1)
    four = cost_mod.build_cost(tr, chips=4)
    p = hw.get_profile(four.profile)
    assert one.t_collective == 0.0
    # ring all-reduce wire volume: bytes × 2(n−1)/n over one NVLink way
    assert four.t_collective == pytest.approx(1e9 * 2 * 3 / 4 / p.link_bw)
    assert four.t_compute == pytest.approx(one.t_compute / 4)


def test_cost_composes_launch_contracts(llama_traffic):
    contracts = (ops.gram_contract(4, 16, 64, 64),
                 ops.rowsumsq_contract(8, 16, 2048))
    assert all(c.flops > 0 and c.hbm_bytes() > 0 for c in contracts)
    base = cost_mod.build_cost(llama_traffic)
    with_k = cost_mod.build_cost(llama_traffic, contracts=contracts)
    assert with_k.kernel_flops == pytest.approx(
        base.kernel_flops + sum(c.flops for c in contracts))
    assert with_k.kernel_hbm_bytes == pytest.approx(
        base.kernel_hbm_bytes + sum(c.hbm_bytes() for c in contracts))
    assert with_k.t_compute > base.t_compute
    assert with_k.t_memory > base.t_memory


def test_cost_report_json_round_trips(llama_traffic):
    cr = cost_mod.build_cost(llama_traffic, model="llama3.2-1b")
    d = json.loads(json.dumps(cr.to_json()))
    assert d["model"] == "llama3.2-1b"
    assert d["profile"] == hw.DEFAULT_PROFILE
    assert d["bottleneck"] == cr.bottleneck
    assert d["n_streams"] == 18
    t = json.loads(json.dumps(llama_traffic.to_json()))
    assert t["n_streams"] == 18 and len(t["allowlisted"]) == 1


def test_profiles_registry_holds_the_h100_only():
    assert list(hw.PROFILES) == ["h100-sxm-80gb"] == [hw.DEFAULT_PROFILE]
    p = hw.PROFILES[hw.DEFAULT_PROFILE]
    assert (p.peak_flops_bf16, p.hbm_bw, p.link_bw, p.hbm_bytes,
            p.chips_per_pod) == (989e12, 3.35e12, 450e9, 80e9, 8)
    assert p.name in p.describe()
    with pytest.raises(KeyError, match="unknown hardware profile"):
        hw.get_profile("tpu-v5e")


def test_flat_constants_track_default_profile():
    p = hw.PROFILES[hw.DEFAULT_PROFILE]
    assert hw.PEAK_FLOPS_BF16 == p.peak_flops_bf16
    assert hw.HBM_BW == p.hbm_bw
    assert hw.LINK_BW == p.link_bw
    assert hw.HBM_BYTES == p.hbm_bytes
    assert hw.CHIPS_PER_POD == p.chips_per_pod


def test_cost_states_its_denominators(llama_traffic):
    cr = cost_mod.build_cost(llama_traffic, profile="h100-sxm-80gb")
    assert "h100-sxm-80gb" in cr.summary()
    assert cost_mod.contract_seconds(ops.gram_contract(8, 512, 2048, 512)) \
        == pytest.approx(max(ops.flop_estimate(8, 512, 2048, 512) / 989e12,
                             ops.norm_bytes(8, 512, 2048, 512,
                                            torch.bfloat16) / 3.35e12))


# ---------------------------------------------------------------------------
# the baseline gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_report(llama_traffic):
    return cost_mod.build_cost(llama_traffic, model="llama3.2-1b")


def test_baseline_gate_round_trip_is_clean(llama_report):
    baseline = cost_mod.baseline_payload([llama_report])
    assert not cost_mod.check_baseline([llama_report], baseline)


def test_baseline_gate_fails_on_growth(llama_report):
    baseline = cost_mod.baseline_payload([llama_report])
    baseline[cost_mod.baseline_key(llama_report)]["hbm_bytes"] *= 0.5
    out = cost_mod.check_baseline([llama_report], baseline)
    assert any(f.code == "cost-regression" and f.severity == ERROR
               and "hbm_bytes" in f.message for f in out)


def test_baseline_gate_warns_on_shrink_and_churn(llama_report):
    baseline = cost_mod.baseline_payload([llama_report])
    baseline[cost_mod.baseline_key(llama_report)]["flops"] *= 2.0
    baseline["gone/example/plan"] = {"flops": 1.0}
    out = cost_mod.check_baseline([llama_report], baseline)
    assert out and all(f.severity == WARNING for f in out)
    assert {f.code for f in out} == {"cost-baseline-stale"}


def test_baseline_gate_warns_on_missing_key(llama_report):
    out = cost_mod.check_baseline([llama_report], {})
    assert [f.code for f in out] == ["cost-baseline-missing"]
    assert out[0].severity == WARNING


def test_committed_baseline_matches_head():
    """The port's committed baseline agrees with head's predictions for
    llama3.2-1b — every plan of the lint, both granularities."""
    from repro_torch.analysis.__main__ import lint_arch
    with open(cost_mod.BASELINE_PATH) as f:
        baseline = json.load(f)
    found, costs = lint_arch("llama3.2-1b", deep=False, cost=True)
    assert not found and len(costs) == 4
    assert all(cost_mod.baseline_key(c) in baseline for c in costs)
    assert all(set(row) == set(cost_mod.BASELINE_METRICS)
               for row in baseline.values())
    out = cost_mod.check_baseline(costs, baseline, full_matrix=False)
    assert not out, [f.render() for f in out]
    assert len(baseline) == 40       # ten archs × 2 granularities × 2 plans


@pytest.mark.parametrize("granularity", ["example", "token"])
def test_remat_grows_only_the_activation_backward(granularity):
    """llama3.2-1b's lint step with its default remat against remat off:
    every phase but activation-bwd the same bytes, flops and contraction
    flops, activation-bwd more of each (the recompute of both backwards),
    so what remat adds to the cost baseline is the recompute alone."""
    spec, cfg, loss_fn, params, batch = lint_config("llama3.2-1b")
    off = registry.make_loss_fn_v2(spec, dataclasses.replace(cfg,
                                                             remat=False))
    on, no = (traffic.check_train_step(fn, params, batch, _dp(granularity),
                                       granularity=granularity)
              for fn in (loss_fn, off))
    for field in ("phase_bytes", "phase_flops", "phase_contraction_flops"):
        a, b = dict(getattr(on, field)), dict(getattr(no, field))
        assert a.keys() == b.keys() == set(traffic.PHASES)
        for ph in traffic.PHASES:
            if ph == traffic.PH_ACT:
                assert a[ph] > b[ph], field
            else:
                assert a[ph] == b[ph], (field, ph)


def test_plan_static_cost_and_describe():
    plan = plan_mod.analyze([pex.Clip(1.0),
                             pex.Noise(0.1, torch.Generator()), pex.GNS()])
    est = plan.static_cost(fwd_flops=1e9, param_bytes=1e6)
    assert est["regions"] == 1 and est["backwards"] == 2
    assert est["grad_stream_reads"] == 2
    assert est["flops_est"] == pytest.approx(5e9)
    assert est["grad_bytes_est"] == pytest.approx(3e6)
    desc = plan.describe(fwd_flops=1e9, param_bytes=1e6)
    assert "flops≈5e+09" in desc and "grad_bytes≈3e+06" in desc
    assert "flops" not in plan.describe()
    assert plan.describe().startswith("regions=1 backwards=2")
    norms_only = plan_mod.analyze([pex.Norms()])
    assert norms_only.static_cost(fwd_flops=1e9)["flops_est"] \
        == pytest.approx(3e9)
    assert plan_mod.analyze([]).static_cost(fwd_flops=1e9)["flops_est"] \
        == pytest.approx(1e9)


# ---------------------------------------------------------------------------
# mutants (tests/test_pexcost_mutation.py in the port)
# ---------------------------------------------------------------------------

def _verify(loss_fn, params, batch):
    eng = pex.Engine(pex.PexSpec())
    return eng.verify(loss_fn, params, batch, [_dp()],
                      allow=registry.untapped_allowlist("llama3.2-1b"),
                      seq=8, deep=False, cost=True, model="llama3.2-1b")


def _codes(rep):
    return {f.code for f in rep.findings}


def _doubled(real):
    def doubled(plan, acc_loss, params, batch, bs, layout, **kw):
        lv, aux, sq, grads, w, tw, cc = real(plan, acc_loss, params, batch,
                                             bs, layout, **kw)
        lv2, *_ = real(plan, acc_loss, params, batch, bs, layout, **kw)
        return lv + 0.0 * lv2, aux, sq, grads, w, tw, cc
    return doubled


def test_extra_gradient_stream_is_detected(monkeypatch):
    """A gradient-normalizing pre-pass bolted onto the optimizer streams
    the tree beyond the code's count: a hard redundant-hbm-stream."""
    real = adamw.update

    def normalizing_update(cfg, state, p, grads):
        gn = torch.sqrt(sum(torch.sum(torch.square(g))
                            for g in tree_leaves(grads)))
        return real(cfg, state, p, tree_map(lambda g: g / (gn + 1e-6),
                                            grads))

    monkeypatch.setattr(adamw, "update", normalizing_update)
    rep = _verify(*_setup())
    assert not rep.ok
    assert "redundant-hbm-stream" in _codes(rep)
    (tr,) = rep.traffic
    assert tr.n_streams > tr.expected_streams


def test_duplicated_forward_is_detected(monkeypatch):
    monkeypatch.setattr(plan_mod, "run_fused", _doubled(plan_mod.run_fused))
    rep = _verify(*_setup())
    assert not rep.ok
    assert "duplicate-forward" in _codes(rep)
    (tr,) = rep.traffic
    assert tr.forward_flops > 1.5 * tr.ref_forward_flops


def test_dropped_residual_sharing_is_detected(monkeypatch):
    """The reweighted gradients taken from a second forward and its own
    backwards, instead of the norms pass's residuals."""
    real = plan_mod.run_fused

    def relinearized(plan, acc_loss, params, batch, bs, layout, **kw):
        lv, aux, sq, _, w, tw, cc = real(plan, acc_loss, params, batch, bs,
                                         layout, **kw)
        _, _, _, grads, *_ = real(plan, acc_loss, params, batch, bs,
                                  layout, **kw)
        return lv, aux, sq, grads, w, tw, cc

    monkeypatch.setattr(plan_mod, "run_fused", relinearized)
    rep = _verify(*_setup())
    assert not rep.ok
    assert "dead-residual" in _codes(rep)
    (tr,) = rep.traffic
    assert tr.residual_sharing < 0.25


def _bf16(params):
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, params)


def test_silent_f32_upcast_is_detected(monkeypatch):
    """A bf16 gradient tree copied to f32 before the optimizer reads it
    trips upcast-materialization, and only it."""
    real = adamw.update

    def upcasting_update(cfg, state, p, grads):
        return real(cfg, state, p,
                    tree_map(lambda g: g.to(torch.float32), grads))

    monkeypatch.setattr(adamw, "update", upcasting_update)
    loss_fn, params, batch = _setup()
    rep = _verify(loss_fn, _bf16(params), batch)
    assert _codes(rep) == {"upcast-materialization"}
    (tr,) = rep.traffic
    assert tr.n_streams <= tr.expected_streams


def test_bf16_params_alone_stay_clean():
    loss_fn, params, batch = _setup()
    rep = _verify(loss_fn, _bf16(params), batch)
    assert rep.ok and not rep.findings, rep.summary()


def test_mutants_fire_through_the_cli_gate(monkeypatch):
    monkeypatch.setattr(plan_mod, "run_fused", _doubled(plan_mod.run_fused))
    assert lint_main(["--arch", "llama3.2-1b", "--fast", "--cost",
                      "--fail-on-error"]) == 1


# ---------------------------------------------------------------------------
# plan invariants on recorded programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_plan_invariants_hold(arch):
    loss_fn, params, batch = _setup(arch)
    pi.assert_disabled_spec_is_plain(loss_fn, params, batch)
    pi.assert_unrequested_norms_dce(loss_fn, params, batch)
    pi.assert_empty_plan_is_plain(loss_fn, params, batch)
    pi.assert_grads_plan_is_plain(loss_fn, params, batch)
    pi.assert_backward_budget(loss_fn, params, batch,
                              [pex.Clip(1.0), pex.Grads()])
    pi.assert_fused_epsilon(loss_fn, params, batch, [pex.Clip(1.0)], _dp())


def test_plan_invariant_checks_have_teeth(monkeypatch):
    with pytest.raises(AssertionError, match="plain forward"):
        pi.check_empty_plan(2.0, 1.0)
    with pytest.raises(AssertionError, match="exceeds plain"):
        pi.check_grads_plan(2.0, 1.0)
    with pytest.raises(AssertionError, match="one-forward budget"):
        pi.check_backward_budget(10.0, 4.0, 3.0, 1.0)    # budget 6
    with pytest.raises(AssertionError, match="not folding"):
        pi.check_fused_epsilon(2.0, 1.0)
    with pytest.raises(AssertionError, match="disabled taps"):
        pi.check_dce(1.0, 2.0, 1.0, 1.0, exact=True)
    # a doubled forward breaks the budget on the recorded program
    monkeypatch.setattr(plan_mod, "run_fused", _doubled(plan_mod.run_fused))
    loss_fn, params, batch = _setup()
    with pytest.raises(AssertionError, match="one-forward budget"):
        pi.assert_backward_budget(loss_fn, params, batch,
                                  [pex.Clip(1.0), pex.Grads()])


def test_engine_verify_reports_traffic_and_cost():
    loss_fn, params, batch = _setup()
    eng = pex.Engine(pex.PexSpec())
    rep = eng.verify(loss_fn, params, batch, [_dp(), [pex.Norms()]],
                     deep=False, cost=True, model="llama3.2-1b",
                     optimizer="adafactor", chips=2)
    assert rep.ok
    assert [t.optimizer for t in rep.traffic] == ["adafactor", "none"]
    assert [c.chips for c in rep.cost] == [2, 2]
    assert "traffic[example/adafactor]" in rep.summary()
    assert "cost[llama3.2-1b/example] on h100-sxm-80gb×2" in rep.summary()
