"""Launch contracts for Hopper (``repro_torch.kernels.contract`` and the
contract functions in ``kernels.ops``), the provenance markers, and the
analysis trace's kernel sites against the launches the wrappers make — on
the CPU, no JAX.

  * ``validate`` refuses each budget it checks: shared memory over
    232,448 B, a bf16 accumulator, a misaligned TMA stride, a wgmma N of
    12, and the rest; every contract at the main path's shapes
    (llama3.2-1b at full width, B=8, S=512; phi3.5-moe's experts) passes.
  * Each bf16 body's shared memory a block, as ``kernels.ops`` states it,
    is what ``kernel_info()`` read on the H100 (PERF.md §6); the card
    holds them again in ``chip_smoke.py`` phase 40 and in
    ``tests/test_torch_cuda.py``.
  * ``mark_*`` outside a trace return the very object; a ``meta`` tensor
    reaches no kernel wrapper and no all-reduce outside a trace.
  * With the wrappers' CUDA branch taken on CPU tensors (their launchers
    pointed at the plain versions), one step of each path of ``chip_smoke``
    (main, flash, moe, token) at smoke widths makes exactly the launches,
    by kernel and by operand shape, that the trace of that step names —
    and ``chip_smoke``'s own expectations (``main_path_launches``,
    ``pass_launches``, ``token_pass_launches``) agree with both.
"""
import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch import pex
from repro_torch.analysis import _trace
from repro_torch.analysis.__main__ import lint_config
from repro_torch.core import provenance as prov
from repro_torch.core import taps
from repro_torch.kernels import contract as C
from repro_torch.kernels import direct_norm as dn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gram_norm as gn
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rowsumsq as rs
from repro_torch.kernels import segmented_norm as sn
from repro_torch.models import registry

BF = torch.bfloat16


def _ok():
    return C.LaunchContract(
        "k", (4, 2), 256, 100_000, 2, registers=64,
        buffers=(C.Buffer("ring", (2, 128, 64), BF),
                 C.Buffer("acc", (128, 128), torch.float32, where="regs",
                          accumulator=True)),
        tma=(C.TmaDesc("h", 0, (4096, 2 * 4096 * 512), (64, 128, 1), 2),),
        wgmma=(C.Wgmma(64, 128, 16, BF),),
        divisibility=(C.Divisibility("S", 512, 128),))


def test_validate_accepts_a_well_formed_launch():
    assert C.validate(_ok()) == []


@pytest.mark.parametrize("change,what", [
    (dict(smem_bytes=232_449, blocks_per_sm=1), "exceeds the 232448 B"),
    (dict(blocks_per_sm=3), "resident blocks"),
    (dict(threads=1056), "threads a block"),
    (dict(grid=(0, 2)), "grid axis 0"),
    (dict(grid=(4, 70_000)), "grid axis 1"),
    (dict(registers=256), "registers a thread"),
    (dict(registers=160), "exceed the SM's 65536"),
    (dict(buffers=(C.Buffer("acc", (128, 128), BF, where="regs",
                            accumulator=True),)), "accumulator 'acc'"),
    (dict(wgmma=(C.Wgmma(64, 128, 16, BF, acc_dtype=BF),)),
     "wgmma accumulates in bfloat16"),
    (dict(tma=(C.TmaDesc("h", 0, (4104,), (64, 128, 1), 2),)),
     "stride of 4104 B"),
    (dict(tma=(C.TmaDesc("h", 8, (4096,), (64, 128, 1), 2),)),
     "global base 8 B"),
    (dict(tma=(C.TmaDesc("h", 0, (4096,), (64, 512, 1), 2),)),
     "box (64, 512, 1)"),
    (dict(wgmma=(C.Wgmma(64, 12, 16, BF),)), "wgmma N=12"),
    (dict(wgmma=(C.Wgmma(96, 128, 16, BF),)), "wgmma M=96"),
    (dict(wgmma=(C.Wgmma(64, 128, 32, BF),)), "wgmma K=32"),
    (dict(divisibility=(C.Divisibility("S", 500, 128),)),
     "S=500 is not divisible"),
    (dict(buffers=(C.Buffer("ring", (4, 128, 256), BF),)),
     "buffers take"),
], ids=["smem", "resident-smem", "threads", "grid-x", "grid-y", "regs",
        "regs-sm", "bf16-acc", "bf16-wgmma-acc", "tma-stride", "tma-base",
        "tma-box", "wgmma-n12", "wgmma-m", "wgmma-k", "divisibility",
        "buffers"])
def test_validate_refuses(change, what):
    errs = C.validate(dataclasses.replace(_ok(), **change))
    assert errs and any(what in e for e in errs), errs


def _main_contracts():
    cfg = registry.get("llama3.2-1b").full()
    b, s = chip_smoke.B, chip_smoke.S
    out = []
    shapes = [sh for block, _ in chip_smoke.model_shapes(cfg) for sh in block]
    for p_in, p_out in shapes + [chip_smoke.head_shape(cfg)]:
        for dt in (BF, torch.float32):
            out.append(ops.gram_contract(b, s, p_in, p_out, dtype=dt))
            out.append(ops.direct_contract(b, s, p_in, p_out, dtype=dt))
            out.append(ops.rowsumsq_contract(b, s, p_in, dtype=dt))
            out.append(ops.clip_scale_contract(b, s, p_out, dtype=dt))
    a = cfg.attn
    for dt in (BF, torch.float32):
        out += ops.attention_contracts(b, a.n_heads, a.n_kv, s, s,
                                       a.head_dim, dtype=dt)
    m = registry.get("phi3.5-moe").full().moe
    t = m.n_experts * m.capacity(chip_smoke.MOE_S * 2) * 16
    for dt in (BF, torch.float32):
        out += ops.segmented_contract(t, 16 * m.n_experts * 2, m.d_model,
                                      m.d_ff, dtype=dt)
    return out


def test_contracts_at_main_shapes_validate():
    cs = _main_contracts()
    assert {c.kernel for c in cs} >= {
        "gram_norm", "direct_norm", "rowsumsq", "clip_scale",
        "segmented_norm", "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"}
    for c in cs:
        assert C.validate(c) == [], c.kernel
    gram = ops.gram_contract(8, 512, 2048, 2048)
    plan = gn.plan(8, 512, 2048, 2048)
    assert gram.grid == (len(plan.work),) and gram.tma
    assert ops.direct_contract(8, 512, 2048, 8192).grid == (16, 32, 8)


def test_contracts_state_the_card_readings():
    """Shared memory a block and threads, as ``kernel_info()`` read them on
    the H100 80GB HBM3 (PERF.md §6)."""
    assert (ops.gram_smem_bytes(),
            ops.gram_contract(8, 512, 2048, 512).threads) == (99_376, 288)
    assert (ops.direct_smem_bytes(), ops.direct_contract(
        8, 512, 2048, 512).threads) == (197_696, 288)
    seg = ops.segmented_contract(4096, 64, 4096, 6400)[0]
    assert (seg.smem_bytes, seg.threads) == (50_176, 128)
    assert [ops.flash_smem_bytes(k, 64) for k in ("fwd", "dq", "dkv")] \
        == [66_584, 99_432, 84_512]


def test_check_info_compares_with_kernel_info():
    c = ops.gram_contract(8, 512, 2048, 2048)
    info = {"registers": 112, "local_bytes": 0, "smem_bytes": 99_376,
            "threads": 288, "blocks_per_sm": 2}
    assert C.check_info(c, info) == []
    assert C.check_info(c, {**info, "smem_bytes": 99_384})
    assert C.check_info(c, {**info, "threads": 256})
    assert C.check_info(c, {**info, "registers": 255})
    assert C.check_info(c, {**info, "blocks_per_sm": 1})


def test_unaligned_rows_take_no_tma_map():
    c = ops.gram_contract(2, 64, 72, 40, strides=((64 * 73, 73, 1), None))
    assert c.tma == () and C.validate(c) == []


# ---------------------------------------------------------------------------
# markers and the trace-only hooks
# ---------------------------------------------------------------------------

def test_marks_outside_a_trace_return_the_very_object():
    x = torch.ones(3)
    g = torch.Generator()
    tree = {"a": [x]}
    assert not prov.tracing()
    assert prov.mark_clip(x, clip_norm=1.0, eps=1e-6,
                          granularity="example") is x
    assert prov.mark_seed(x, kind="plain") is x
    assert prov.mark_noise(x, noise_std=0.1, scale=1.0, leaf=0) is x
    assert prov.mark_sample(x, k=1) is x
    assert prov.mark_grad_leaf(x, leaf=0) is x
    assert prov.mark_grad_tree(tree) is tree
    assert prov.mark_rng(g, purpose="noise") is g
    assert prov.mark(x, prov.TAG_CLIP, a=1) is x


def test_meta_tensors_reach_no_launch_outside_a_trace():
    h = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or on a CUDA"):
        ops.gram_norm(h, h)
    with pytest.raises(ValueError, match="outside an analysis trace"):
        prov.kernel_site("gram_norm", (h, h), h)
    with pytest.raises(ValueError, match="outside an analysis trace"):
        prov.collective_site(h, kind="reduce", count=2)


def test_pex_ops_table():
    assert taps.identify_pex_op(taps._Dense).name == "dense"
    assert taps.identify_pex_op(taps._Embed).weight_slots == (0,)
    assert taps.identify_pex_op(taps._DenseExpert).n_operands == 5
    assert taps.identify_pex_op(ops._FlashAttention) is None
    assert set(taps.PEX_OPS) == {taps._Dense, taps._DenseBatched,
                                 taps._Bias, taps._Scale, taps._Embed,
                                 taps._DenseExpert}


# ---------------------------------------------------------------------------
# the trace's kernel sites against the launches the wrappers make
# ---------------------------------------------------------------------------

class _CountedLaunches:
    """The wrappers' CUDA branch on CPU tensors: ``ops._on_cpu`` answers
    False and each launcher is its plain version; records what
    ``chip_smoke.phase_main`` records (norm shapes, segmented calls,
    ``rowsumsq`` rows)."""

    def __init__(self, monkeypatch):
        self.norm_shapes, self.seg, self.rows = set(), [], []
        monkeypatch.setattr(ops, "_on_cpu", lambda what, *t: False)

        def norm(fn):
            def launch(h, z, **kw):
                self.norm_shapes.add(chip_smoke.norm_key(h, z))
                return fn(h, z)
            return launch

        def seg(h, z, ids, n):
            self.seg.append((h.shape[0], h.shape[1], z.shape[1], n))
            return sn.segmented_norm_ref(h, z, ids, n)

        def rows(x):
            self.rows.append(tuple(x.shape))
            return ref.rowsumsq_ref(x)

        def fwd(q, k, v, **kw):
            return fa.flash_attention_fwd_ref(q, k, v, **kw)

        def dq(q, k, v, do, lse, delta, **kw):
            return fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                 **kw)

        def dkv(q, k, v, do, lse, delta, **kw):
            return fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                  **kw)

        monkeypatch.setattr(gn, "gram_norm", norm(ref.gram_norm_ref))
        monkeypatch.setattr(dn, "direct_norm", norm(dn.direct_norm_ref))
        monkeypatch.setattr(sn, "segmented_norm", seg)
        monkeypatch.setattr(rs, "rowsumsq", rows)
        monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
        monkeypatch.setattr(fa, "flash_attention_bwd_dq", dq)
        monkeypatch.setattr(fa, "flash_attention_bwd_dkv", dkv)


def _smoke(arch, flash=False, layers=None):
    spec = registry.get(arch)
    cfg = spec.smoke()
    if flash:
        cfg = chip_smoke.with_flash(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return spec, cfg


@pytest.mark.parametrize("tag,arch,flash,token", [
    ("main", "llama3.2-1b", False, False),
    ("flash", "llama3.2-1b", True, False),
    ("moe", "phi3.5-moe", False, False),
    ("token", "llama3.2-1b", False, True),
])
def test_trace_names_the_launches_of_a_step(monkeypatch, tag, arch, flash,
                                            token):
    spec, cfg = _smoke(arch, flash)
    b, s = 4, 128                       # flash takes S % 128 == 0
    loss_fn, params, batch = chip_smoke.meta_setup(spec, registry, cfg,
                                                   (b, s))
    gen = torch.Generator().manual_seed(1)
    cons = chip_smoke.path_consumers(pex, token, gen)
    gran = "token" if token else "example"
    tr = _trace.trace_step(loss_fn, params, batch, cons, granularity=gran)

    real = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    counted = _CountedLaunches(monkeypatch)
    ops.reset_launch_counts()
    pex.Engine(pex.PexSpec(), granularity=gran).step(
        loss_fn, real, batch, chip_smoke.path_consumers(pex, token, gen))
    launches = ops.launch_counts()
    assert tr.kernel_counts() == {k: n for k, n in launches.items() if n}
    fwd, norms, grads = (chip_smoke.token_pass_launches(cfg) if token
                         else chip_smoke.pass_launches(
                             chip_smoke.main_path_launches(cfg, s), cfg))
    assert launches == {k: fwd[k] + norms[k] + grads[k] for k in launches}
    assert tr.norm_launches() == ({"gram_norm": {}, "direct_norm": {}}
                                  if token else
                                  chip_smoke.main_path_launches(cfg, s))
    run = {"launches": launches, "norm_shapes": counted.norm_shapes,
           "seg_calls": [[(None, n, t, pi, po, None)
                          for t, pi, po, n in counted.seg]],
           "row_calls": [[(sh, None) for sh in counted.rows]]}
    monkeypatch.setattr(chip_smoke, "STEPS", 1)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    chip_smoke.check_trace_launches(tag, tr, run, cfg, s, token)


def test_engine_verify_smoke_is_ok():
    _, cfg, loss_fn, params, batch = lint_config("llama3.2-1b")
    gen = torch.Generator().manual_seed(0)
    rep = pex.Engine(pex.PexSpec()).verify(
        loss_fn, params, batch,
        [[pex.Norms(), pex.Clip(1.0), pex.Noise(0.1, gen), pex.GNS()],
         [pex.Norms(), pex.Grads()]], cfg=cfg)
    assert rep.ok, rep.summary()
    assert len(rep.privacy) == 2 and rep.determinism.ok
    dense = sum(site.op == "dense" for site in rep.coverage.sites)
    assert [sum(tr.norm_launches()["gram_norm"].values())
            + sum(tr.norm_launches()["direct_norm"].values())
            for tr in rep.traces] == [dense] * 2
