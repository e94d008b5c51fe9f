"""The port's kernels against the JAX reference's.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run their
plain PyTorch versions; the reference's Pallas kernels run in interpret
mode, as ``tests/test_kernels.py`` runs them. Inputs are made with numpy
from a seed and handed to both. Tolerance: f32, 1e-5 relative (summation
order); ``clip_scale`` exactly (one product and one rounding per element
on both sides). The CUDA kernels themselves are tested on a card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import direct_norm as tdn
from repro_torch.kernels import gram_norm as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5

# (B, S, p_in, p_out): tiny, ragged S and p (not multiples of any tile),
# p_in ≠ p_out both ways, S=1, and one S spanning three 64-row tiles
SHAPES = [(2, 16, 24, 40), (3, 37, 80, 200), (1, 130, 70, 33),
          (2, 64, 128, 96), (2, 1, 8, 5), (1, 150, 40, 72)]


def _pair(shape, seed):
    b, s, pi, po = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, pi)).astype(np.float32),
            rng.normal(size=(b, s, po)).astype(np.float32))


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_gram_norm_matches_reference(shape, triangular):
    h, z = _pair(shape, 0)
    want = np.asarray(jops.gram_norm(jnp.asarray(h), jnp.asarray(z),
                                     triangular=triangular))
    got = tops.gram_norm(torch.from_numpy(h), torch.from_numpy(z),
                         triangular=triangular)
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_direct_norm_matches_reference(shape):
    h, z = _pair(shape, 1)
    want = np.asarray(jops.direct_norm(jnp.asarray(h), jnp.asarray(z)))
    got = tops.direct_norm(torch.from_numpy(h), torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_direct_norm_ref_chunking_exact():
    """The plain direct version's p_in chunking (a ragged last chunk
    included) only reorders the sum."""
    h, z = _pair((2, 20, 50, 30), 2)
    h, z = torch.from_numpy(h), torch.from_numpy(z)
    whole = tdn.direct_norm_ref(h, z, chunk=50)
    for chunk in (1, 7, 16, 64):
        np.testing.assert_allclose(tdn.direct_norm_ref(h, z, chunk).numpy(),
                                   whole.numpy(), rtol=RTOL)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions; the launch
    counters count CUDA launches only."""
    h, z = _pair((2, 16, 24, 40), 3)
    h, z = torch.from_numpy(h), torch.from_numpy(z)
    q, k = h[:, None, :, :16], z[:, None, :, :16]      # (B, 1, S, 16)
    tops.reset_launch_counts()
    tops.gram_norm(h, z)
    tops.direct_norm(h, z)
    o, lse = tops.flash_attention(q, k, k, scale=0.25, return_lse=True)
    tops.flash_attention_bwd(q, k, k, o, lse, o, scale=0.25)
    tops.segmented_norm(h[0], z[0], torch.arange(16) % 3, 2)
    tops.rowsumsq(h, 2)
    tops.clip_scale(h, torch.ones(2))
    assert tops.launch_counts() == {
        "gram_norm": 0, "direct_norm": 0, "segmented_norm": 0,
        "rowsumsq": 0, "clip_scale": 0,
        "flash_attention": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0}


@pytest.mark.parametrize("fn", ["gram_norm", "direct_norm"])
def test_wrappers_reject_other_devices(fn):
    """Neither a mixed CPU/meta pair nor a meta pair falls back to the plain
    version; the CUDA launcher refuses non-CUDA tensors."""
    h = torch.empty(2, 8, 4, device="meta")
    z = torch.empty(2, 8, 3, device="meta")
    with pytest.raises(ValueError):
        getattr(tops, fn)(h, z)
    with pytest.raises(ValueError):
        getattr(tops, fn)(torch.zeros(2, 8, 4), z)
    with pytest.raises(ValueError):
        getattr({"gram_norm": tgn, "direct_norm": tdn}[fn], fn)(
            torch.zeros(2, 8, 4), torch.zeros(2, 8, 3))


def test_row_wrappers_reject_other_devices():
    """``rowsumsq`` and ``clip_scale`` take CPU or CUDA tensors only, and
    their CUDA launchers refuse CPU tensors."""
    from repro_torch.kernels import clip_scale as tcs
    from repro_torch.kernels import rowsumsq as trs
    z = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError):
        tops.rowsumsq(z)
    with pytest.raises(ValueError):
        tops.clip_scale(z, torch.ones(2))
    with pytest.raises(ValueError):
        trs.rowsumsq(torch.zeros(2, 8, 4))
    with pytest.raises(ValueError):
        tcs.clip_scale(torch.zeros(2, 8, 4), torch.ones(2))
    with pytest.raises(ValueError):
        tops.clip_scale(torch.zeros(2, 8, 4), torch.ones(3))
    with pytest.raises(ValueError):
        tops.rowsumsq(torch.zeros(2, 8), keep=3)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means no kernels: the build raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_gram_flop_model_halves():
    """The triangular grid's work approaches half the full grid's. The
    kernel's estimate counts its own 128-row tiles; the bound counts 64-row
    tiles whatever the kernels' tiles are."""
    full = tgn.flop_estimate(1, 4096, 512, 512, triangular=False)
    tri = tgn.flop_estimate(1, 4096, 512, 512, triangular=True)
    assert 1.9 < full / tri < 2.0
    # a ragged last tile counts at its true height: 130 = 128 + 2 rows in
    # the kernel's tiles, 64 + 64 + 2 in the bound's
    def work(pairs):
        return sum(2.0 * a * b * (10 + 20 + 1) for a, b in pairs)
    wide = work([(128, 128), (128, 2), (2, 2)])
    narrow = work([(64, 64), (64, 64), (64, 2), (64, 64), (64, 2), (2, 2)])
    assert tgn.flop_estimate(1, 130, 10, 20) == wide
    assert tgn.bound_flop_estimate(1, 130, 10, 20) == narrow


@pytest.mark.parametrize("shape, route", [
    ((8, 512, 2048, 128256), "gram"),   # the LM head: forced to direct
    ((8, 512, 2048, 512), "gram"),      # wk / wv: the halved grid beats
                                        # direct, which pick_method's
                                        # logical model takes
    ((2, 512, 16, 16), "direct"),
    ((8, 512, 2048, 8192), "gram"),     # up / gate
    ((3, 37, 80, 200), "gram")])
def test_least_work_takes_the_cheaper_route(shape, route):
    """``ops.flop_estimate`` is the fewer operations of the two forms,
    whichever the dispatch runs: the work a bound holds the kernel to. The
    gram form is counted over the triangle of 64-row tile pairs (36 pairs at
    S=512), the bound's own count, not at the kernel's 128-row tiles, so the
    bound column keeps its numbers when a kernel's tile changes."""
    b, s, pi, po = shape
    est = {"gram": tgn.bound_flop_estimate(*shape),
           "direct": tdn.flop_estimate(*shape)}
    assert tops.flop_estimate(*shape) == est[route] == min(est.values())
    if s == 512:
        assert est["gram"] == b * 36 * 2.0 * 64 * 64 * (pi + po + 1)
    assert est["gram"] != tgn.flop_estimate(*shape) or s <= 64


def _dt_pair(x, dtype):
    """The same numpy values as a JAX and a torch array of ``dtype``
    (bfloat16 rounds to nearest even on both sides)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# (B, N): tiny, ragged N (not a multiple of 8 or of a 128-lane tile), one
# row, and one N spanning two of the reference's 2048-wide tiles
ROWS = [(8, 16), (3, 37), (1, 130), (16, 2500), (2, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROWS)
def test_rowsumsq_matches_reference(shape, dtype):
    """The plain version against the reference's Pallas kernel, f32 and
    bf16 inputs, 1e-5 relative (the bf16 products are exact in f32)."""
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jx, tx = _dt_pair(x, dtype)
    want = np.asarray(jops.rowsumsq(jx))
    got = tops.rowsumsq(tx)
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(tref.rowsumsq_ref(tx).numpy(),
                               np.asarray(jref.rowsumsq_ref(jx)), rtol=RTOL)


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_rowsumsq_keeps_leading_axes(keep):
    """``keep`` leading axes stay (the token layout's (B, S) form is
    keep=2); the rest are summed, as the reference's wrapper flattens
    them for keep=1; a strided (B, S, p) view gives the same sums."""
    x = np.random.default_rng(6).normal(size=(3, 4, 5, 6)).astype(np.float32)
    want = np.sum(x.astype(np.float64) ** 2, axis=tuple(range(keep, 4)))
    got = tops.rowsumsq(torch.from_numpy(x), keep)
    assert got.shape == x.shape[:keep]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    if keep == 1:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.rowsumsq(jnp.asarray(x))), rtol=RTOL)
    view = torch.from_numpy(x)[:, :, 1]                  # (3, 4, 6) strided
    np.testing.assert_allclose(tops.rowsumsq(view, 2).numpy(),
                               np.sum(x[:, :, 1] ** 2, -1), rtol=RTOL)
    assert tops.rowsumsq(torch.zeros(0, 4, 5), 2).shape == (0, 4)


CLIP_SHAPES = [(2, 5, 7), (3, 16, 256), (1, 1, 130), (4, 33, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CLIP_SHAPES)
def test_clip_scale_matches_reference_kernel(shape, dtype):
    """The plain version equals the reference's Pallas kernel exactly:
    both multiply in f32 and round once. c holds 0, 1 and values below
    1."""
    rng = np.random.default_rng(7)
    z = rng.normal(size=shape).astype(np.float32)
    c = np.concatenate([[0.0, 1.0], rng.uniform(0.01, 1.0, 8)])[:shape[0]]
    c = c.astype(np.float32)
    jz, tz = _dt_pair(z, dtype)
    want = jops.clip_scale(jz, jnp.asarray(c))
    got = tops.clip_scale(tz, torch.from_numpy(c))
    assert got.dtype == tz.dtype and got.shape == tz.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_clip_scale_ref_rounds_once_unlike_the_reference_oracle():
    """The reference's ``clip_scale_ref`` casts c to z's dtype before the
    product: in f32 it equals the port's plain version, in bf16 it may
    differ from it (and from both kernels) by one bf16 rounding, never
    more (ROADMAP Queue 3, a reference behaviour)."""
    rng = np.random.default_rng(8)
    z = rng.normal(size=(6, 9, 64)).astype(np.float32)
    c = rng.uniform(0.01, 1.0, 6).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jz, tz = _dt_pair(z, dtype)
        want = np.asarray(jref.clip_scale_ref(jz, jnp.asarray(c))
                          .astype(jnp.float32))
        got = tref.clip_scale_ref(tz, torch.from_numpy(c)).float().numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
            assert np.all(np.abs(got - want) <= ulp)


def _c_entry_points():
    """{name: [parameter declarations]} of every ``extern "C" int``
    function defined in the package's CUDA sources."""
    import re
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = params
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argtypes_match_the_c_entry_points(name):
    """ctypes passes each argument as its argtypes say: a count that
    differs from the C definition's would shift every later argument."""
    params = _c_entry_points()[name]
    assert len(params) == len(_build._SIGNATURES[name])
    for decl, argtype in zip(params, _build._SIGNATURES[name]):
        if "*" in decl:
            assert argtype in (_build._P, _build._LP, _build._IP), decl
        elif decl.startswith("float"):
            assert argtype is _build._F, decl
        elif decl.startswith("long long"):
            assert argtype is _build._L, decl
        else:
            assert argtype is _build._I, decl


@pytest.mark.parametrize("name", ["flash_attention_fwd_launch",
                                  "flash_attention_bwd_dq_launch",
                                  "flash_attention_bwd_dkv_launch"])
def test_flash_launches_take_their_route_from_the_launcher(name):
    """Each flash launch takes the copy route as an argument (``tma``):
    the kernels keep no rule of their own."""
    assert "int tma" in _c_entry_points()[name]
