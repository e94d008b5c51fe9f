"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode). The
file imports no JAX, so it runs on a GPU machine without the reference's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 relative (summation order), bf16 5e-4 relative (bf16
inputs, whose products are exact in f32; f32 accumulation in both, in
another order). The bf16 limit sits well above the largest reading on the
card and below what one 128-wide tile of G dropped or doubled would read.
The flash attention kernels are held to 1e-4 (f32) and 1e-2 (bf16: O, dQ,
dK and dV round to bf16, and the kernels round P and dS to bf16 for the
tensor cores) of each output's max |value|, the lse to 1e-4 of its max in
both types.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import direct_norm as tdn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gram_norm as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, S, p_in, p_out): ragged S and p, S=1, three 64-row tiles, and one of
# llama3.2-1b's main-path shapes
SHAPES = [(2, 16, 24, 40), (3, 37, 80, 200), (1, 130, 70, 33),
          (2, 64, 128, 96), (2, 1, 8, 5), (1, 150, 40, 72),
          (2, 512, 2048, 512)]


def _counts(**nonzero):
    """``launch_counts()`` as it should read: the given kernels, the
    rest 0."""
    return {**dict.fromkeys(tops.launch_counts(), 0), **nonzero}


def _pair(shape, seed):
    b, s, pi, po = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, pi)).astype(np.float32),
            rng.normal(size=(b, s, po)).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, shape, dtype):
    """f32: 1e-4 relative (summation order); bf16: 5e-4 relative."""
    dt = getattr(torch, dtype)
    rtol = 1e-4 if dtype == "float32" else 5e-4
    h, z = (torch.from_numpy(x).to(cuda_device, dt) for x in _pair(shape, 4))
    want = tref.gram_norm_ref(h, z)
    tops.reset_launch_counts()
    tgn.route_launches.clear()
    tdn.route_launches.clear()
    for got in (tops.gram_norm(h, z), tops.gram_norm(h, z, triangular=False),
                tops.direct_norm(h, z)):
        torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
    assert tops.launch_counts() == _counts(gram_norm=2, direct_norm=1)
    # contiguous bf16 rows whose width is a multiple of 8 take TMA; the odd
    # widths (37, 33, 5) are no multiple of 16 bytes and are staged
    bf = dtype == "bfloat16"
    route = "tma" if all(p % 8 == 0 for p in shape[2:]) else "synchronous"
    assert dict(tgn.route_launches) == ({("gram", route): 2} if bf else {})
    assert dict(tdn.route_launches) == ({("direct", route): 1} if bf else {})


@pytest.mark.cuda
def test_cuda_kernels_take_strided_inputs(cuda_device):
    """Batch/sequence strides go to the kernel as they are; a
    non-contiguous feature axis is copied by the wrapper."""
    h, z = (torch.from_numpy(x).to(cuda_device) for x in
            _pair((3, 40, 24, 36), 5))
    want = tref.gram_norm_ref(h, z)
    hs = torch.stack([h, h], dim=2).reshape(3, 80, 24)[:, ::2]  # S stride 2
    zt = z.transpose(1, 2).contiguous().transpose(1, 2)   # feature stride S
    torch.testing.assert_close(tops.gram_norm(hs, zt), want, rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(tops.direct_norm(hs, zt), want, rtol=1e-4,
                               atol=0.0)


@pytest.mark.cuda
def test_cuda_bf16_unaligned_rows(cuda_device):
    """bf16 rows whose base is not 16-byte aligned and whose stride is odd
    take the element-by-element staging path of the tensor-core bodies."""
    h, z = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in
            _pair((3, 40, 25, 37), 6))
    h, z = h[:, :, 1:], z[:, :, 1:]
    want = tref.gram_norm_ref(h, z)
    tgn.route_launches.clear()
    tdn.route_launches.clear()
    torch.testing.assert_close(tops.gram_norm(h, z), want, rtol=5e-4,
                               atol=0.0)
    torch.testing.assert_close(tops.direct_norm(h, z), want, rtol=5e-4,
                               atol=0.0)
    assert dict(tgn.route_launches) == {("gram", "synchronous"): 1}
    assert dict(tdn.route_launches) == {("direct", "synchronous"): 1}


# (B, S, p_in, p_out, offset) of bf16 launches whose plan splits the
# feature axes into several ranges (n_h or n_z > 1), on the TMA route
# (offset 0) and the staged one (rows 8 elements wide shifted by one
# element: a base no multiple of 16 bytes)
SPLIT_CASES = [(2, 300, 2048, 9000, 0), (1, 700, 9000, 1000, 0),
               (2, 200, 3000, 5000, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_cuda_gram_split_plans(cuda_device, case, triangular):
    """A plan with split feature ranges: the partial Grams are summed in a
    fixed order before the fold, so the norm matches the plain version at
    5e-4 and repeats bit for bit."""
    b, s, pi, po, off = case
    h, z = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in
            _pair((b, s, pi + off, po + off), 7))
    h, z = h[:, :, off:], z[:, :, off:]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tgn.plan(b, s, pi, po, triangular, sms)
    assert plan.n_h + plan.n_z > 2
    tgn.route_launches.clear()
    got = tops.gram_norm(h, z, triangular=triangular)
    again = tops.gram_norm(h, z, triangular=triangular)
    torch.testing.assert_close(got, tref.gram_norm_ref(h, z), rtol=5e-4,
                               atol=0.0)
    assert torch.equal(got, again)
    route = "synchronous" if off else "tma"
    assert dict(tgn.route_launches) == {("gram", route): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1])
def test_cuda_direct_is_bitwise_repeatable(cuda_device, off):
    """bf16 direct launches over several p_in and p_out tiles and a ragged
    sequence, on both routes, give the same bits twice."""
    h, z = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in
            _pair((3, 333, 300 + off, 700 + off), 8))
    h, z = h[:, :, off:], z[:, :, off:]
    got, again = tops.direct_norm(h, z), tops.direct_norm(h, z)
    torch.testing.assert_close(got, tref.gram_norm_ref(h, z), rtol=5e-4,
                               atol=0.0)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_norm_kernel_info(cuda_device):
    """The bf16 bodies' resources as the runtime reports them: two
    warpgroups and a producer warp, no local memory."""
    for info in (tgn.kernel_info(), tdn.kernel_info()):
        assert info["threads"] == 288 and info["blocks_per_sm"] >= 1
        assert info["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-7b", "minitron-4b",
                                  "gemma2-9b", "qwen2-vl-7b"])
def test_cuda_engine_step_matches_cpu(cuda_device, arch):
    """The smoke step of each dense config (gemma2 at S=96, past its
    window of 8; qwen2-vl with its visual inputs) on the card (kernels)
    against the same step on the CPU (plain versions), f32; the launches
    follow the priced ``pick_method``, the LM head's included."""
    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core.norms import pick_method
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_map

    spec = registry.get(arch)
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    shape = ShapeSpec("t", "train", 96, 3)
    batch = registry.make_train_batch(spec, cfg, shape, 0, device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec())
    want = eng.step(loss_fn, params, batch, [pex.Norms(), pex.Grads()])
    tops.reset_launch_counts()
    got = eng.step(loss_fn, tree_map(lambda x: x.to(cuda_device), params),
                   {k: v.to(cuda_device) for k, v in batch.items()},
                   [pex.Norms(), pex.Grads()])
    torch.testing.assert_close(got.sq_norms.cpu(), want.sq_norms, rtol=1e-4,
                               atol=0.0)
    a = cfg.attn
    d, hq, hkv, f = (cfg.d_model, a.n_heads_p * a.head_dim,
                     a.n_kv * a.head_dim, cfg.mlp.d_ff)
    layer = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (f, d)]
    if cfg.mlp.gated:
        layer.append((d, f))
    picks = [pick_method(shape.seq, pi, po, use_kernels=True)
             for pi, po in layer] * cfg.n_layers
    picks.append(pick_method(shape.seq, d, cfg.vocab, use_kernels=True))
    assert tops.launch_counts() == _counts(gram_norm=picks.count("gram"),
                                           direct_norm=picks.count("direct"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 4, 3), (2, 0, 4, 3), (2, 8, 0, 3),
                                   (2, 8, 4, 0)])
def test_cuda_empty_inputs_launch_nothing(cuda_device, shape):
    """A zero extent has the norm 0; the wrappers answer it without a
    launch and leave the counters alone."""
    b, s, pi, po = shape
    h = torch.zeros(b, s, pi, device=cuda_device)
    z = torch.zeros(b, s, po, device=cuda_device)
    tops.reset_launch_counts()
    for got in (tops.gram_norm(h, z), tops.direct_norm(h, z)):
        assert got.shape == (b,) and got.device == h.device
        assert not bool(got.any())
    assert tops.launch_counts() == _counts()


# (B, Hq, Hkv, S, D, softcap, window, layout) of chip_smoke's flash kernel
# checks: llama3.2-1b's main-path shape, ragged S, MHA, D=32, D=128, a
# window, a softcap, all three of ragged, window and softcap together, S a
# multiple of 64 but not of 128, one row past a tile, a window smaller than
# a q tile, rep = 8, qwen2-vl-7b's shape (rep 8 at D=128), and two strided
# layouts: q, k and v sliced out of one
# fused projection (16-byte strides: the TMA route) and out of
# (B, S, H, D + 1) tensors (the synchronous route, at D = 64, 128 and 32,
# whose tiles are laid out apart)
FLASH_CASES = [(8, 32, 8, 512, 64, None, None, None),
               (2, 8, 2, 200, 64, None, None, None),
               (2, 4, 4, 256, 64, None, None, None),
               (2, 4, 4, 192, 32, None, None, None),
               (2, 8, 2, 256, 128, None, None, None),
               (2, 8, 2, 512, 64, None, 128, None),
               (2, 8, 2, 256, 64, 50.0, None, None),
               (1, 4, 2, 333, 64, 30.0, 100, None),
               (2, 8, 2, 320, 64, None, None, None),
               (2, 4, 2, 65, 64, None, None, None),
               (2, 8, 2, 256, 64, None, 48, None),
               (2, 32, 4, 256, 64, None, None, None),
               (8, 32, 4, 512, 128, None, None, None),
               (2, 8, 2, 200, 64, None, None, "fused"),
               (2, 8, 2, 200, 64, None, None, "odd"),
               (1, 8, 2, 320, 128, 20.0, 48, "odd"),
               (2, 4, 2, 200, 32, None, None, "odd")]


def _flash_inputs(case, dtype, device, seed=7):
    """q, k, v, dO as (B, H, S, D) views: of (B, S, H, D) tensors as the
    model passes them, or laid out as the case's layout says."""
    b, hq, hkv, s, d = case[:5]
    layout = case[7] if len(case) > 7 else None
    rng = np.random.default_rng(seed)

    def draw(h, width=d):
        return torch.from_numpy(rng.normal(size=(b, s, h, width))
                                .astype(np.float32)).to(device, dtype)
    if layout == "fused":
        q, k, v = draw(hq + 2 * hkv).split((hq, hkv, hkv), dim=2)
        do = draw(hq)
    elif layout == "odd":
        q, k, v, do = (draw(h, d + 1)[..., :d] for h in (hq, hkv, hkv, hq))
    else:
        q, k, v, do = (draw(h) for h in (hq, hkv, hkv, hq))
    return [x.transpose(1, 2) for x in (q, k, v, do)]


def _flash_kw(case):
    return dict(scale=case[4] ** -0.5, softcap=case[5], window=case[6])


def _of_max(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_kernels_match_plain(cuda_device, case, dtype):
    """O and lse, then dQ, dK, dV on the plain forward's O and lse."""
    tol = 1e-4 if dtype == "float32" else 1e-2
    q, k, v, do = _flash_inputs(case, getattr(torch, dtype), cuda_device)
    kw = _flash_kw(case)
    tops.reset_launch_counts()
    tfa.route_launches.clear()
    o, lse = tops.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = tfa.flash_attention_fwd_ref(q, k, v, **kw)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert _of_max(o, o_ref) <= tol
    assert _of_max(lse, lse_ref) <= 1e-4
    got = tops.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
    want = tfa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _of_max(g, w) <= tol
    assert tops.launch_counts() == _counts(flash_attention=1,
                                           flash_attention_bwd_dq=1,
                                           flash_attention_bwd_dkv=1)
    # the route each bf16 launch was given: the model's views and the fused
    # projection by TMA, rows of an odd pitch staged
    route = "synchronous" if case[7] == "odd" else "tma"
    assert dict(tfa.route_launches) == (
        {("fwd", route): 1, ("dq", route): 1, ("dkv", route): 1}
        if dtype == "bfloat16" else {})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_is_bitwise_deterministic(cuda_device, dtype):
    """No atomics: the same inputs give the same bits."""
    case = (2, 8, 2, 333, 64, None, None)
    q, k, v, do = _flash_inputs(case, getattr(torch, dtype), cuda_device)
    kw = _flash_kw(case)
    o, lse = tops.flash_attention(q, k, v, return_lse=True, **kw)
    first = tops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(3):
        again = tops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(o, tops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 256])
def test_cuda_flash_unsupported_head_dim_raises(cuda_device, d):
    q, k, v, do = _flash_inputs((1, 2, 1, 64, d, None, None), torch.float32,
                                cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q, k, v, scale=0.1)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention_bwd(q, k, v, q, lse, do, scale=0.1)


@pytest.mark.cuda
def test_cuda_flash_vjp_matches_plain_autograd(cuda_device):
    """The autograd Function on the card against autograd through the
    plain oracle, f32."""
    case = (2, 4, 2, 256, 64, None, None)
    q, k, v, do = _flash_inputs(case, torch.float32, cuda_device)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tops.flash_attention_vjp(*leaves, 0.125), leaves,
                              do)
    want = torch.autograd.grad(tref.flash_attention_ref(*leaves, scale=0.125),
                               leaves, do)
    for g, w in zip(got, want):
        assert _of_max(g, w) <= 1e-4


@pytest.mark.cuda
def test_cuda_flash_engine_step_matches_cpu(cuda_device):
    """The smoke llama step with ``AttnCfg.flash`` and a head dim the
    kernels take (32) on the card against the same step on the CPU, f32;
    one forward and one backward launch per layer (the fused backward)."""
    import dataclasses

    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_flatten, tree_map

    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, head_dim=32, flash=True))
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", 128,
                                                           3), 0,
                                      device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec())
    want = eng.step(loss_fn, params, batch, [pex.Norms(), pex.Grads()])
    tops.reset_launch_counts()
    got = eng.step(loss_fn, tree_map(lambda x: x.to(cuda_device), params),
                   {k: v.to(cuda_device) for k, v in batch.items()},
                   [pex.Norms(), pex.Grads()])
    counts = tops.launch_counts()
    assert {k: counts[k] for k in ("flash_attention", "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv")} == \
        dict.fromkeys(("flash_attention", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv"), cfg.n_layers)
    torch.testing.assert_close(got.sq_norms.cpu(), want.sq_norms, rtol=1e-4,
                               atol=0.0)
    for g, w in zip(tree_flatten(got.grads)[0], tree_flatten(want.grads)[0]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


# (T, p_in, p_out, n_seg, drop fraction) of the segmented kernel checks:
# ragged T and p (not multiples of a 128-wide tile or a 16/32-row chunk),
# one segment, many small segments (the MoE path's ~32 rows each), and a
# segment longer than many staged chunks
SEG_CASES = [(7, 3, 5, 2, 0.2), (130, 12, 40, 9, 0.2), (100, 140, 36, 3, 0.5),
             (33, 260, 7, 33, 0.2), (129, 64, 129, 1, 0.3),
             (2200, 192, 200, 64, 0.25), (700, 130, 257, 1, 0.0)]


def _seg_case(case, dtype, device, seed=8):
    t, p_in, p_out, n, drop = case
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, size=(t,))
    seg = np.where(rng.random(t) < drop, n + rng.integers(0, 5, size=(t,)),
                   seg)
    return (torch.from_numpy(rng.normal(size=(t, p_in)).astype(np.float32))
            .to(device, dtype),
            torch.from_numpy(rng.normal(size=(t, p_out)).astype(np.float32))
            .to(device, dtype),
            torch.from_numpy(seg).to(device), n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEG_CASES)
def test_cuda_segmented_matches_plain(cuda_device, case, dtype):
    """f32: 1e-4 relative (summation order); bf16: 5e-4 relative (bf16
    products are exact in f32, accumulated in another order). An empty
    segment is exactly 0; a second run gives the same bits."""
    from repro_torch.kernels import segmented_norm as tsn
    rtol = 1e-4 if dtype == "float32" else 5e-4
    h, z, seg, n = _seg_case(case, getattr(torch, dtype), cuda_device)
    want = tsn.segmented_norm_ref(h, z, seg, n)
    tops.reset_launch_counts()
    tsn.reset_route_counts()
    got = tops.segmented_norm(h, z, seg, n)
    again = tops.segmented_norm(h, z, seg, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
    assert torch.equal(got, again)
    assert tops.launch_counts() == _counts(segmented_norm=2)
    sizes = tsn.segment_sizes(seg, n).cpu().numpy()
    gram = tsn.takes_gram(sizes, case[1], case[2])
    assert tsn.route_segments() == {
        "gram": 2 * int(gram.sum()),
        "direct": 2 * int(((sizes > 0) & ~gram).sum())}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_segmented_mixed_routes(cuda_device, dtype):
    """Segments of 1, 63, 64, 65, 128 and 300 rows, empty ones and dropped
    rows at 200 → 136 in one launch: up to 65 rows on the gram route (one
    or three tile pairs), 128 and 300 on the direct route; each route's
    kernel launched once, with the launcher's copy route."""
    from repro_torch.kernels import segmented_norm as tsn
    dt = getattr(torch, dtype)
    sizes = [1, 0, 63, 64, 0, 65, 128, 300, 0]
    rng = np.random.default_rng(12)
    seg = np.concatenate([np.full(k, j) for j, k in enumerate(sizes)]
                         + [len(sizes) + rng.integers(0, 4, size=30)])
    seg = torch.from_numpy(rng.permutation(seg)).to(cuda_device)
    t = seg.shape[0]
    h, z = (torch.from_numpy(rng.normal(size=(t, p)).astype(np.float32))
            .to(cuda_device, dt) for p in (200, 136))
    want = tsn.segmented_norm_ref(h, z, seg, len(sizes))
    tsn.reset_route_counts()
    got = tops.segmented_norm(h, z, seg, len(sizes))
    torch.testing.assert_close(got, want, rtol=1e-4 if dtype == "float32"
                               else 5e-4, atol=0.0)
    assert (got[torch.tensor(sizes) == 0] == 0).all()
    assert torch.equal(got, tops.segmented_norm(h, z, seg, len(sizes)))
    copy = "cp.async" if dtype == "bfloat16" else "fma"
    assert tsn.route_launches == {("gram", copy): 2, ("direct", copy): 2}
    assert tsn.route_segments() == {"gram": 8, "direct": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_segmented_edge_cases(cuda_device, dtype):
    """All rows dropped, empty segments, one segment, and the zero extents
    the wrapper answers without a launch."""
    dt = getattr(torch, dtype)
    h, z = (torch.ones(48, p, device=cuda_device, dtype=dt) for p in (8, 4))
    got = tops.segmented_norm(h, z, torch.full((48,), 7, device=cuda_device),
                              3)
    assert torch.equal(got, torch.zeros(3, device=cuda_device))
    seg = torch.full((48,), 2, device=cuda_device)
    got = tops.segmented_norm(h, z, seg, 5)
    assert got.tolist() == [0.0, 0.0, 48.0 ** 2 * 32, 0.0, 0.0]
    got = tops.segmented_norm(h, z, torch.zeros(48, device=cuda_device,
                                                  dtype=torch.long), 1)
    assert got.tolist() == [48.0 ** 2 * 32]
    tops.reset_launch_counts()
    for t, pi, po, n in ((0, 8, 4, 2), (5, 0, 4, 2), (5, 8, 0, 2),
                         (5, 8, 4, 0)):
        got = tops.segmented_norm(
            torch.zeros(t, pi, device=cuda_device, dtype=dt),
            torch.zeros(t, po, device=cuda_device, dtype=dt),
            torch.zeros(t, device=cuda_device, dtype=torch.long), n)
        assert got.shape == (n,) and not bool(got.any())
    assert tops.launch_counts() == _counts()


@pytest.mark.cuda
def test_cuda_segmented_strided_and_unaligned_rows(cuda_device):
    """Rows of a wider tensor (row stride > p) go to the kernel as they
    are; bf16 rows whose base is not 16-byte aligned take the element
    staging path."""
    from repro_torch.kernels import segmented_norm as tsn
    h, z, seg, n = _seg_case((300, 41, 77, 12, 0.2), torch.float32,
                             cuda_device)
    want = tsn.segmented_norm_ref(h, z, seg, n)
    hw = torch.zeros(300, 50, device=cuda_device)
    hw[:, 3:44] = h
    torch.testing.assert_close(tops.segmented_norm(hw[:, 3:44], z, seg, n),
                               want, rtol=1e-4, atol=0.0)
    hb, zb = h.to(torch.bfloat16), z.to(torch.bfloat16)
    want = tsn.segmented_norm_ref(hb[:, 1:], zb[:, 1:], seg, n)
    tsn.reset_route_counts()
    torch.testing.assert_close(tops.segmented_norm(hb[:, 1:], zb[:, 1:], seg,
                                                   n), want, rtol=5e-4,
                               atol=0.0)
    assert {c for _, c in tsn.route_launches} == {"synchronous"}


@pytest.mark.cuda
def test_cuda_moe_engine_step_matches_cpu(cuda_device):
    """The smoke phi3.5-moe step (two dispatch groups, capacity drops) on
    the card against the same step on the CPU, f32; three segmented
    launches per layer in the folded backward."""
    import dataclasses

    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_flatten, tree_map

    spec = registry.get("phi3.5-moe")
    cfg = spec.smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=2, capacity_factor=0.5))
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", 40,
                                                           4), 0,
                                      device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec())
    want = eng.step(loss_fn, params, batch, [pex.Norms(), pex.Grads()])
    tops.reset_launch_counts()
    got = eng.step(loss_fn, tree_map(lambda x: x.to(cuda_device), params),
                   {k: v.to(cuda_device) for k, v in batch.items()},
                   [pex.Norms(), pex.Grads()])
    assert tops.launch_counts()["segmented_norm"] == 3 * cfg.n_layers
    torch.testing.assert_close(got.sq_norms.cpu(), want.sq_norms, rtol=1e-4,
                               atol=0.0)
    for g, w in zip(tree_flatten(got.grads)[0], tree_flatten(want.grads)[0]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


# (B, S, N) rows of the rowsumsq / clip_scale checks: a ragged width (not a
# multiple of 8), one row, narrow rows (warp per row), one width on each
# side of the block-per-row switch (16,384), and a head-wide row
ROW_SHAPES = [(3, 37, 77), (1, 1, 1000), (2, 64, 512), (2, 8, 16383),
              (2, 4, 16384), (1, 3, 128256)]


def _rows(shape, dtype, device, seed=9):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_cuda_rowsumsq_matches_plain(cuda_device, shape, dtype):
    """1e-5 relative in both types (bf16 products are exact in f32; the sums
    differ in order only), and the same bits on a second launch."""
    x = _rows(shape, dtype, cuda_device)
    tops.reset_launch_counts()
    got = tops.rowsumsq(x, 2)
    again = tops.rowsumsq(x, 2)
    torch.testing.assert_close(got, tref.rowsumsq_ref(x), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(got, again)
    assert tops.launch_counts() == _counts(rowsumsq=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rowsumsq_strided_and_unaligned(cuda_device, dtype):
    """A (B, S) view with batch and sequence strides is read where it lies;
    rows that start off a 16-byte boundary take the scalar head."""
    x = _rows((4, 2, 40, 70), dtype, cuda_device)
    for view in (x[:, 1], x[:, 0, ::3], x[:, 0, :, 3:], x[:, 1, :, 1:66]):
        torch.testing.assert_close(tops.rowsumsq(view, 2),
                                   tref.rowsumsq_ref(view), rtol=1e-5,
                                   atol=0.0)
    torch.testing.assert_close(tops.rowsumsq(x), tref.rowsumsq_ref(
        x.reshape(4, -1)), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROW_SHAPES[:5] + [(5, 9, 2048)])
def test_cuda_clip_scale_equals_plain(cuda_device, shape, dtype):
    """Exactly the plain version (one f32 product, one rounding), with c
    holding 0, 1 and values below 1; strided and unaligned z too."""
    z = _rows(shape, dtype, cuda_device)
    c = torch.tensor([0.0, 1.0, 0.3, 0.05, 0.999], device=cuda_device)
    c = c[:shape[0]]
    tops.reset_launch_counts()
    got = tops.clip_scale(z, c)
    assert torch.equal(got, tref.clip_scale_ref(z, c))
    assert torch.equal(got, tops.clip_scale(z, c))
    assert tops.launch_counts() == _counts(clip_scale=2)
    for view in (z[:, ::2], z[..., 1:], z[:, :, :-3]):
        assert torch.equal(tops.clip_scale(view, c),
                           tref.clip_scale_ref(view, c))


@pytest.mark.cuda
def test_cuda_row_wrappers_empty_inputs_launch_nothing(cuda_device):
    tops.reset_launch_counts()
    assert tops.rowsumsq(torch.zeros(2, 0, 5, device=cuda_device),
                         2).shape == (2, 0)
    assert not bool(tops.rowsumsq(torch.zeros(2, 3, 0, device=cuda_device),
                                  2).any())
    empty = tops.clip_scale(torch.zeros(2, 0, 5, device=cuda_device),
                            torch.ones(2, device=cuda_device))
    assert empty.shape == (2, 0, 5)
    assert tops.launch_counts() == _counts()


@pytest.mark.cuda
def test_cuda_token_step_matches_cpu(cuda_device):
    """The smoke llama token-clip step on the card (rowsumsq kernel)
    against the same step on the CPU (plain version), f32; the launches
    are 2 per dense tap, 1 per scale tap and 1 for the embedding, all in
    the norms backward, and no norm kernel."""
    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_flatten, tree_map

    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", 96,
                                                           3), 0,
                                      device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec(), granularity="token")
    consumers = [pex.Clip(1.0, granularity="token"), pex.Grads()]
    want = eng.step(loss_fn, params, batch, consumers)
    tops.reset_launch_counts()
    got = eng.step(loss_fn, tree_map(lambda x: x.to(cuda_device), params),
                   {k: v.to(cuda_device) for k, v in batch.items()},
                   consumers)
    n = cfg.n_layers
    assert tops.launch_counts() == _counts(
        rowsumsq=2 * (7 * n + 1) + (2 * n + 1) + 1)
    torch.testing.assert_close(got.sq_norms.cpu(), want.sq_norms, rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(got.clip_coef.cpu(), want.clip_coef,
                               rtol=1e-4, atol=0.0)
    for g, w in zip(tree_flatten(got.grads)[0], tree_flatten(want.grads)[0]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [False, True])
def test_cuda_onepass_matches_cpu(cuda_device, seq):
    """Paper §6 one-pass on the card against the CPU, f32: one clip_scale
    launch per tapped layer; the MLP form's norms from two rowsumsq
    launches per layer, the sequence form's from the gram/direct route."""
    from repro_torch.core import clipping

    rng = np.random.default_rng(10)
    b, s, d = 6, 40, 24
    lead = (b, s) if seq else (b,)
    params = {k: torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32)
                                  * 0.3) for k in ("w1", "w2")}
    batch = {k: torch.from_numpy(rng.normal(size=lead + (d,))
                                 .astype(np.float32)) for k in ("x", "y")}
    shapes = {"w1": lead + (d,), "w2": lead + (d,)}

    def forward(p, tp, bt):
        h1 = torch.tanh(bt["x"] @ p["w1"] + tp["w1"])
        z2 = h1 @ p["w2"] + tp["w2"]
        lv = torch.sum(torch.square(z2 - bt["y"]).reshape(b, -1), -1)
        return lv, {"w1": bt["x"], "w2": h1}

    fn = clipping.onepass_clipped_weight_grads_seq if seq \
        else clipping.onepass_clipped_weight_grads
    _, want_sq, want_w = fn(forward, params, batch, shapes, 0.5)
    tops.reset_launch_counts()
    _, sq, wbar = fn(forward, {k: v.to(cuda_device) for k, v in
                               params.items()},
                     {k: v.to(cuda_device) for k, v in batch.items()},
                     shapes, 0.5)
    n = tops.launch_counts()
    assert n["clip_scale"] == 2
    assert n["rowsumsq"] == (0 if seq else 4)
    torch.testing.assert_close(sq.cpu(), want_sq, rtol=1e-4, atol=0.0)
    for k in params:
        torch.testing.assert_close(wbar[k].cpu(), want_w[k], rtol=1e-4,
                                   atol=1e-4 * float(want_w[k].abs().max()))


@pytest.mark.cuda
def test_cuda_token_slot_scatter_is_bitwise_repeatable(cuda_device):
    """A token's top-k expert slots add into one (B, S) entry; on CUDA the
    scatter gives the same bits on every run."""
    from repro_torch.core.taps import TokenLayout

    rng = np.random.default_rng(11)
    ng, e, c, bg, s = 2, 8, 300, 4, 128
    x, z = (torch.from_numpy(rng.normal(size=(ng, e, c, d))
                             .astype(np.float32)).to(cuda_device)
            for d in (64, 48))
    tok = torch.from_numpy(rng.integers(-1, bg * s + 1, size=(ng, e, c))
                           ).to(cuda_device)
    seg = torch.zeros_like(tok)
    acc = torch.zeros(ng * bg, s, device=cuda_device)
    layout = TokenLayout(s)
    first = layout.add_expert_grouped(acc, x, z, seg, 0, bg, True, tok=tok)
    for _ in range(5):
        assert torch.equal(
            layout.add_expert_grouped(acc, x, z, seg, 0, bg, True, tok=tok),
            first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_embedding_grad_and_stat_are_bitwise_repeatable(cuda_device,
                                                             dtype):
    """Many rows of one id add into one table row (the embedding backward)
    and into one per-example segment (``stat_embedding``); on CUDA both
    give the same bits on every run, and the gradient equals a plain
    per-row sum."""
    from repro_torch.core import norms
    from repro_torch.core.taps import ExampleLayout, PexSpec, Tap

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    b, s, v, d = 4, 512, 40, 256           # ~51 rows of each id
    ids = torch.from_numpy(rng.integers(0, v, (b, s))).to(cuda_device)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda_device, dt)
    zbar = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)
                            ).to(cuda_device, dt)

    def run():
        t = table.detach().requires_grad_()
        acc = ExampleLayout(1).init(b, cuda_device).requires_grad_()
        tap = Tap(PexSpec(), acc=acc, layout=ExampleLayout(1))
        tap.set_mode(norms=True, grads=True)
        z = tap.embedding(t, ids, group="all")
        out = torch.sum(z.float() * zbar.float()) + torch.sum(
            tap.carry() * 0.0)
        gt, gacc = torch.autograd.grad(out, (t, acc))
        return gt, gacc, norms.stat_embedding(ids, zbar)

    first = run()
    for _ in range(4):
        for a, w in zip(run(), first):
            assert torch.equal(a, w)
    want = torch.zeros(v, d, dtype=torch.float64, device=cuda_device)
    want.index_add_(0, ids.reshape(-1), zbar.reshape(-1, d).double())
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]   # one rounding
    torch.testing.assert_close(first[0].double(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    torch.testing.assert_close(first[1][:, 0], first[2], rtol=0, atol=0)


# --- bit-exact restore and replay: deterministic backward sums --------------

def _tenant_step_rows(device, dtype=torch.float32):
    """One fused tenant step (Clip, no noise) from a fresh store: the
    updated rows of 6 tenants with 5 examples each, so the gather's
    backward adds 5 rows into each tenant's gradient."""
    from repro_torch.nn import lora as tlora
    from repro_torch.nn.linear import linear
    from repro_torch.nn.param import tree_leaves, tree_map
    from repro_torch.tenancy import AdapterStore, TenantService

    rng = np.random.default_rng(21)
    d, o, r, s = 64, 48, 8, 16
    base = torch.from_numpy(0.2 * rng.normal(size=(d, o)).astype(
        np.float32)).to(device, dtype)
    owner = rng.permutation(np.repeat(np.arange(100, 106), 5))
    batch = {k: torch.from_numpy(rng.normal(size=(owner.size, s, n)).astype(
        np.float32)).to(device, dtype) for k, n in (("x", d), ("y", o))}

    def init_fn(g):
        # drawn on the CPU from the tenant's seed: a card's generator draws
        # other numbers than the CPU's, and the CPU's step is the yardstick
        cpu = torch.Generator().manual_seed(g.initial_seed())
        return tree_map(lambda x: x.to(device), {"site": tlora.init_pair(
            cpu, d, o, r, 16.0, dtype=dtype, device="cpu", b_std=0.3)})

    def loss(adapters, data, tap):
        z = linear({"w": base, "lora": adapters["site"]}, data["x"], tap=tap)
        tok = torch.sum(torch.square(z.float() - data["y"].float()), dim=-1)
        return torch.sum(tap.token_loss(tok), dim=1), {}

    store = AdapterStore(init_fn, capacity=8, seed=3, device=device)
    TenantService(store, loss, clip_norm=1.0, lr=0.1).step(batch, owner)
    return [x.clone() for x in tree_leaves(store.gather(np.unique(owner)))]


@pytest.mark.cuda
def test_cuda_tenant_adapter_grads_are_bitwise_repeatable(cuda_device):
    """The tenant gather's backward (``core.norms.add_rows``, not
    ``index_select``'s atomic ``index_add_``) gives each tenant's updated
    adapter rows the same bits on 5 runs; they match the CPU's step."""
    first = _tenant_step_rows(cuda_device)
    for _ in range(4):
        assert all(torch.equal(a, w) for a, w in zip(
            _tenant_step_rows(cuda_device), first))
    for got, want in zip(first, _tenant_step_rows(torch.device("cpu"))):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def _moe_backward(device):
    """deepseek-v2's smoke MoE layer at top-6 of 8 experts (each token
    dispatched 6 times, so its input gradient sums 6 slots): the gradients
    of x and of every expert weight, and the per-example norms."""
    import dataclasses

    from repro_torch.configs import deepseek_v2_236b
    from repro_torch.core.taps import ExampleLayout, PexSpec, Tap
    from repro_torch.nn import moe as tmoe
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    # no drops (capacity for every slot), so the card and the CPU route
    # alike; the weights drawn on the CPU for both
    cfg = dataclasses.replace(deepseek_v2_236b.smoke().moe, top_k=6,
                              capacity_factor=8.0)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(13)
    b, s = 4, 64
    x0 = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(
        np.float32)).to(device)
    ybar = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(
        np.float32)).to(device)
    x = x0.clone().requires_grad_()
    leaves, treedef = tree_flatten(p)
    leaves = [w.to(device).requires_grad_() for w in leaves]
    params = tree_unflatten(treedef, leaves)
    acc = ExampleLayout(1).init(b, device).requires_grad_()
    tap = Tap(PexSpec(), acc=acc, layout=ExampleLayout(1))
    tap.set_mode(norms=True, grads=True)
    y = tmoe.moe(params, x, tap=tap, cfg=cfg, group="all")
    out = torch.sum(y * ybar) + torch.sum(tap.carry() * 0.0)
    return torch.autograd.grad(out, [x, acc] + leaves)


@pytest.mark.cuda
def test_cuda_moe_backward_is_bitwise_repeatable(cuda_device):
    """The MoE dispatch and combine gather by advanced indexing, whose
    backward is the sorted ``index_put_`` with ``accumulate``: on the card
    a top-6 layer's gradients and norms are the same bits on 5 runs, and
    match the CPU's."""
    first = _moe_backward(cuda_device)
    for _ in range(4):
        assert all(torch.equal(a, w) for a, w in zip(
            _moe_backward(cuda_device), first))
    for got, want in zip(first, _moe_backward(torch.device("cpu"))):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


# --- checkpoints on the card ---------------------------------------------------

@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_on_device(cuda_device, tmp_path,
                                             monkeypatch):
    """A bf16 and f32 tree on the card saves and restores onto the card
    bit for bit; the writer thread is handed host numpy bytes only."""
    import threading

    from repro_torch.ckpt import checkpoint as tck
    from repro_torch.nn.param import tree_leaves, tree_map

    seen = []
    write = tck.CheckpointManager._write_inner

    def checked(self, step, host_items, extra):
        seen.append((threading.current_thread() is not
                     threading.main_thread(),
                     all(isinstance(raw, np.ndarray)
                         for _, raw, _, _ in host_items)))
        return write(self, step, host_items, extra)

    monkeypatch.setattr(tck.CheckpointManager, "_write_inner", checked)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(64, 48, generator=gen, device=cuda_device),
            "b": [torch.randn(33, generator=gen, device=cuda_device
                              ).to(torch.bfloat16),
                  torch.randn(7, 5, generator=gen, device=cuda_device)]}
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    mgr.wait()
    assert seen == [(True, True)]
    got, _ = mgr.restore(None, tree_map(torch.zeros_like, tree))
    for a, w in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.device.type == "cuda" and a.dtype == w.dtype
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_cuda_trainer_resume_is_bit_deterministic(cuda_device, tmp_path):
    """The smoke llama3.2-1b trainer on the card: 4 steps straight equal 2
    + resume + 2, parameters and both moments bit for bit."""
    from repro_torch.core.taps import PexSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()

    def trainer(steps, ckpt_dir, every):
        params = registry.family_module(spec).init(
            cfg, torch.Generator(device=cuda_device).manual_seed(0),
            device=cuda_device)
        return Trainer(registry.make_loss_fn_v2(spec, cfg), params,
                       PexSpec(), adamw.AdamWConfig(lr=1e-3),
                       TrainConfig(steps=steps, log_every=0,
                                   ckpt_every=every, ckpt_dir=ckpt_dir),
                       DataConfig(vocab=cfg.vocab, seq=32, global_batch=8),
                       device=cuda_device)

    straight = trainer(4, None, 10 ** 9)
    straight.train()
    trainer(2, str(tmp_path), 2).train()
    resumed = trainer(4, str(tmp_path), 10 ** 9)
    resumed.train(resume=True)
    assert resumed.opt_state.step == 4
    for a, w in zip(tree_leaves(resumed._state_tree()),
                    tree_leaves(straight._state_tree())):
        assert a.is_cuda and torch.equal(a, w)
