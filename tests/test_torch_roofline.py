"""The port's roofline tooling (``repro_torch.roofline``) and its dry-run,
probe and perf launchers (``repro_torch.launch.{dryrun,probes,perf}``) on
the CPU, at smoke configs, with no JAX:

  * each launch contract's roofline reproduces the bound of PERF.md §6
    (``chip_smoke.py``'s formula: the bytes at 3.35 TB/s or the fewest
    operations at 989 TFLOP/s, the larger) at the main path's shapes;
  * the probes' 1–3-layer extrapolation equals a full record in flops and
    bytes (a record counts every layer);
  * the dry-run's liveness pass on toys whose peak is counted by hand
    (autograd's saved tensors kept to the backward op that reads them),
    and on recorded cells at one and four data ranks (a ``fake``
    process-group world, no process spawned);
  * ``roofline.hlo`` over a hand-built record and over the four-rank
    record's all-reduces; the roofline arithmetic; the report's tables;
    the perf variants (on the sharded record of the smoke mesh) and the
    refused remat variants.
"""
import dataclasses
import json
import math

import pytest
import torch

from repro_torch.analysis import _trace
from repro_torch.analysis.cost import contract_seconds
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.kernels import clip_scale as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rowsumsq as rs
from repro_torch.launch import dryrun, perf, probes
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import constants as hw
from repro_torch.roofline import hlo, report

BW, PEAK = 3.35e12, 989e12


def _bound(nbytes, flops):
    return max(nbytes / BW, flops / PEAK)


# ---------------------------------------------------------------------------
# contracts against PERF.md §6's bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pi,po", [(2048, 512), (2048, 2048), (2048, 8192),
                                   (8192, 2048), (2048, 128256)])
def test_norm_contract_roofline_is_the_table_bound(pi, po):
    b, s = 8, 512
    want = _bound(2 * b * s * (pi + po) + 4 * b,
                  ops.flop_estimate(b, s, pi, po))
    for c in (ops.gram_contract(b, s, pi, po),
              ops.direct_contract(b, s, pi, po)):
        assert contract_seconds(c) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_flash_contract_roofline_is_the_table_bound(kind):
    b, hq, hkv, s, d = 8, 32, 8, 512, 64
    (c,) = ops.attention_contracts(b, hq, hkv, s, s, d, kinds=(kind,))
    want = _bound(fa.byte_estimate(kind, b, hq, hkv, s, s, d, 2),
                  fa.flop_estimate(kind, b, hq, s, s, d))
    assert contract_seconds(c) == pytest.approx(want, rel=1e-12)


def test_row_kernel_contracts_are_byte_bound():
    """rowsumsq and clip_scale: the table prices their f32 arithmetic at
    the f32 rate; both are byte-bound at either rate, so the contract's
    roofline is their bytes."""
    c = ops.rowsumsq_contract(8, 512, 128256)
    assert contract_seconds(c) == rs.bytes_estimate(4096, 128256, 2) / BW
    c = ops.clip_scale_contract(8, 512, 8192, dtype=torch.float32)
    assert contract_seconds(c) == cs.bytes_estimate(8 * 512 * 8192, 8, 4) \
        / BW


def test_segmented_contract_counts_the_call_once():
    seg = torch.tensor([0, 0, 1, 2, 2, 2, 3, 3])          # 3: dropped
    with_ids = ops.segmented_contract(8, 3, 64, 64, seg_ids=seg)
    flops, nbytes = ops.segmented_work(8, 3, 64, 64, torch.bfloat16, seg)
    assert (with_ids[0].flops, with_ids[0].hbm_bytes()) == (flops, nbytes)
    assert nbytes == 6 * 128 * 2 + 8 * 8 + 12           # kept rows only
    assert all(c.flops == 0 for c in with_ids[1:])
    static = ops.segmented_contract(8, 3, 64, 64)
    assert static[0].hbm_bytes() == 8 * 128 * 2 + 8 * 4 + 12


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("llama3.2-1b", {"n_layers": 4}),
    ("zamba2-7b", {"n_layers": 7}),
])
def test_probes_extrapolate_to_the_full_record(arch, kw):
    cfg = dataclasses.replace(registry.get(arch).smoke(), **kw)
    d = probes.run_probes(arch, "smoke_train", 1, cfg=cfg, out_dir=None,
                          full_record=True, verbose=False,
                          shape=ShapeSpec("probe", "train", 8, 2))
    for k in ("flops", "bytes"):
        assert d["per_rank"][k] == pytest.approx(d["full_record"][k],
                                                 rel=1e-9), k
    assert len(d["probes"]) == (2 if arch == "llama3.2-1b" else 3)
    assert d["probe_s"] > 0 and d["full_s"] > 0


def test_seamless_probes_combine_encoder_and_decoder():
    """Probes of (1, 1), (2, 1) and (1, 2) layers → (3, 2)."""
    cfg = dataclasses.replace(registry.get("seamless-m4t-medium").smoke(),
                              n_enc=3, n_dec=2)
    ms = [{"flops": 10.0 + 3 * e + 5 * d} for e, d in ((1, 1), (2, 1),
                                                       (1, 2))]
    assert [(c.n_enc, c.n_dec) for c in probes.probe_configs(
        "seamless-m4t-medium", cfg)] == [(1, 1), (2, 1), (1, 2)]
    assert probes.extrapolate("seamless-m4t-medium", ms, cfg) == {
        "flops": 10.0 + 9 + 10}


# ---------------------------------------------------------------------------
# the dry-run's liveness
# ---------------------------------------------------------------------------

def test_liveness_of_a_toy_counted_by_hand():
    """x (resident, 40 B); a = x·2 and b = a + 1 (40 B each, made);
    c = b.sum() (4 B, kept). a dies after b is made, so the peak is
    a + b = 80 B at b's op."""
    def prog(x):
        a = x * 2
        b = a + 1
        return b.sum()

    rec = _trace.Recorder()
    x = torch.empty(10, device="meta")
    with rec:
        xid = rec.tid(x)
        c = prog(x)
        keep = (rec.tid(c),)
    tr = _trace.Trace.of(rec)
    live = dryrun.liveness(tr, {"params": (xid,)}, keep)
    assert live.resident == {"params": 40.0, "other": 0.0}
    assert live.peak == 80.0 and live.at == 1
    assert live.total == 120.0


def test_liveness_keeps_saved_tensors_to_their_backward():
    """y = tanh(x·w) saves y for its backward. Made (f32, 16 × 16 = 1024
    B): P = x·w (dies at tanh), y, the sum (4 B), its seed of ones (4 B,
    expanded: a view), dP = tanh_backward(ones, y), g = xᵀ·dP (kept). y
    stays alive past the sum to tanh's backward, so the peak is y + ones +
    dP = 2052 B there — had y died at its last forward read, the peak
    would be P + y = 2048 B at tanh."""
    n = 16
    x = torch.empty(n, n, device="meta")
    w = torch.empty(n, n, device="meta", requires_grad=True)
    rec = _trace.Recorder()
    with rec:
        ids = (rec.tid(x), rec.tid(w))
        y = torch.tanh(x @ w)
        (g,) = torch.autograd.grad(y.sum(), [w])
        keep = (rec.tid(g),)
    tr = _trace.Trace.of(rec)
    live = dryrun.liveness(tr, {"params": ids}, keep)
    (bwd,) = [op.index for op in tr.ops if op.name.startswith(
        "aten.tanh_backward")]
    assert live.resident == {"params": 2048.0, "other": 0.0}
    assert (live.peak, live.at) == (2052.0, bwd)


def test_dryrun_cells_at_one_and_four_ranks():
    cfg = registry.get("llama3.2-1b").smoke()
    one, tr1 = dryrun.lower_cell("llama3.2-1b", "smoke_train", 1,
                                 cfg_override=cfg)
    four, tr4 = dryrun.lower_cell("llama3.2-1b", "smoke_train", 4,
                                  cfg_override=cfg)
    n = sum(math.prod(tr1.tensors[t].shape) for t in tr1.param_ids)
    for r in (one, four):
        assert r.ok and r.fits
        assert r.param_bytes_per_dev == 4 * n     # f32 smoke, replicated
        assert r.state_bytes_per_dev == 8 * n     # AdamW's two moments
        assert r.peak_bytes_per_dev == pytest.approx(
            r.param_bytes_per_dev + r.state_bytes_per_dev
            + r.batch_bytes_per_dev + r.other_bytes_per_dev
            + r.transient_peak_bytes)
    assert (one.local_batch, four.local_batch) == (8, 2)
    assert one.coll_bytes.get("total", 0.0) == 0.0
    assert four.transient_peak_bytes < one.transient_peak_bytes
    # each gradient leaf all-reduced once, in tree order, over the mesh
    assert four.coll_bytes["all-reduce/reduce"] == 4 * n
    assert four.coll_counts["all-reduce/reduce"] == len(tr4.param_ids)
    refused, _ = dryrun.lower_cell("llama3.2-1b", "smoke_train", 3,
                                   cfg_override=cfg)
    assert not refused.ok and "refused" in refused.reason


def test_dryrun_serve_cell_counts_its_caches():
    aspec = registry.get("llama3.2-1b")
    cfg = aspec.smoke()
    res, _ = dryrun.lower_cell("llama3.2-1b", "smoke_decode", 1,
                               cfg_override=cfg)
    caches = registry.family_module(aspec).init_caches(
        8, registry.serving_config(aspec, cfg, dryrun.shape_spec(
            "smoke_decode")), device="meta")
    want = sum(x.numel() * x.element_size() for x in tree_leaves(caches)
               if isinstance(x, torch.Tensor))
    assert res.ok and res.state_bytes_per_dev == want
    skip, _ = dryrun.lower_cell("llama3.2-1b", "long_500k", 1)
    assert skip.skipped and skip.ok
    assert SHAPES["train_4k"] == ShapeSpec("train_4k", "train", 4096, 256)


# ---------------------------------------------------------------------------
# roofline.hlo, analysis, report
# ---------------------------------------------------------------------------

def _op(i, kind, name, ins, outs, meta=None):
    return _trace.Op(i, kind, name, tuple(ins), tuple(outs), (), meta)


def test_hlo_over_a_hand_built_trace():
    ti = _trace.TensorInfo
    tensors = {1: ti((4, 8), "float32", 10, 128, 128),
               2: ti((16,), "bfloat16", 11, 32, 32),
               3: ti((8, 8), "float32", 12, 256, 256),
               4: ti((4, 8), "float32", 13, 128, 128)}
    tr = _trace.Trace(
        [_op(0, "collective", "all_reduce", [1], [1], {"kind": "reduce"}),
         _op(1, "collective", "all_reduce", [2], [2], {"kind": "gather"}),
         _op(2, "aten", "aten.mm.default", [1, 3], [4], {"flops": 512.0})],
        tensors, {}, frozenset())
    assert hlo.collective_bytes(tr) == {
        "all-reduce": 160.0, "all-reduce/reduce": 128.0,
        "all-reduce/gather": 32.0, "total": 160.0}
    assert hlo.collective_counts(tr) == {
        "all-reduce": 2, "all-reduce/reduce": 1, "all-reduce/gather": 1}
    flops, nbytes = hlo.compiled_cost(tr)
    assert flops == 512.0
    assert nbytes == 2 * 128 + 2 * 32 + (128 + 256) + 128


def test_roofline_arithmetic():
    shp = SHAPES["train_4k"]
    assert ra.model_flops(shp, 1e9) == 6e9 * 4096 * 256
    assert ra.model_flops(SHAPES["decode_32k"], 1e9) == 2e9 * 128
    cfg = registry.get("phi3.5-moe").full()
    n = 1e10
    moe = cfg.moe
    routed = cfg.n_layers * moe.n_experts * 3 * cfg.d_model * moe.d_ff
    assert ra.n_active_for("phi3.5-moe", n, cfg) == pytest.approx(
        n - 32064 * cfg.d_model - routed * (1 - moe.top_k / moe.n_experts))
    m = {"flops": 989e12, "bytes": 3.35e12, "coll_bytes": 4.5e11}
    r = ra.build_roofline("a", "s", "2", m, 494.5e12, 0.0, chips=2)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (0.5, 0.5, 0.5))
    assert r.useful_ratio == 0.5
    assert ra.mfu(r) == pytest.approx(0.5)
    assert r.profile == hw.DEFAULT_PROFILE


def test_report_renders_the_tables(tmp_path):
    cfg = registry.get("llama3.2-1b").smoke()
    res = dryrun.run_cell("llama3.2-1b", "smoke_train", 4,
                          out_dir=str(tmp_path / "dr"), cfg_override=cfg)
    d = probes.run_probes("llama3.2-1b", "train_4k", 1, cfg=cfg,
                          shape=dryrun.shape_spec("smoke_train"),
                          out_dir=str(tmp_path / "rf"),
                          dryrun_dir=str(tmp_path / "dr"), verbose=False)
    assert d["peak_gb_per_dev"] == 0.0   # no cell at 1 rank recorded
    dr = report.load(str(tmp_path / "dr"))
    text = report.dryrun_table(dr)
    assert res.ok
    rf = report.load(str(tmp_path / "rf"))
    assert "llama3.2-1b__smoke_train" in rf
    row = json.dumps(rf)
    assert "mfu_bound" in row
    assert "| llama3.2-1b |" not in text    # smoke shapes are not listed
    text = report.roofline_table({"llama3.2-1b__train_4k":
                                  rf["llama3.2-1b__smoke_train"]})
    assert text.count("| llama3.2-1b | train_4k |") == 1


# ---------------------------------------------------------------------------
# perf variants
# ---------------------------------------------------------------------------

def test_perf_variants_and_refusals():
    cfg = registry.get("deepseek-v2-236b").smoke()
    assert perf.apply_variant(cfg, "moe_local_dispatch").moe \
        .dispatch_groups == 16
    assert perf.apply_variant(cfg, "moe_cf1").moe.capacity_factor == 1.0
    assert cfg.remat and cfg.remat_policy == "full"
    assert perf.apply_variant(cfg, "remat_dots").remat_policy == "dots"
    assert perf.apply_variant(cfg, "no_remat").remat is False
    assert perf.apply_variant(registry.get("rwkv6-3b").smoke(),
                              "no_remat").remat is False
    with pytest.raises(ValueError, match="remat_policy"):
        perf.apply_variant(registry.get("rwkv6-3b").smoke(), "remat_dots")
    with pytest.raises(ValueError, match="needs an MoE config"):
        perf.apply_variant(registry.get("llama3.2-1b").smoke(),
                           "moe_local_dispatch")
    assert not perf.spec_for(["pex_off"]).enabled
    assert perf.spec_for(["pex_gram"]).method == "gram"
    assert perf.spec_for(["pex_factorized"]).method == "factorized"
    assert perf.spec_for(["baseline"]).method == "auto"
    # the variants on the sharded record (the default) of the smoke mesh
    kw = dict(cfg=registry.get("llama3.2-1b").smoke(), out_dir=None,
              verbose=False, smoke=True)
    off = perf.run_variant("llama3.2-1b", "smoke_train", "pex_off", **kw)
    on = perf.run_variant("llama3.2-1b", "smoke_train", "baseline", **kw)
    assert off["mode"] == on["mode"] == "sharded"
    assert off["flops"] < on["flops"]
    # the remat variants run: full recomputes every block's products,
    # dots keeps them and recomputes the attention's
    dots = perf.run_variant("llama3.2-1b", "smoke_train", "remat_dots", **kw)
    plain = perf.run_variant("llama3.2-1b", "smoke_train", "no_remat", **kw)
    assert plain["flops"] < dots["flops"] < on["flops"]
