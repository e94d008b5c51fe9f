"""What surrounds the bf16 gram and direct kernels, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
Here: the gram launcher's plan at the main path's and the LM head's shapes
(tiles, pairs, feature ranges, scratch), the copy-route rule both launchers
share, a plain-torch model of the gram kernel's decomposition (128-row tile
pairs, ranges of 64-feature chunks, partial Grams summed in a fixed order
and then folded) held against the JAX reference's Pallas kernel in
interpret mode at f32 1e-5 (summation order), and the constants and entry
points the Python side shares with ``csrc/``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import direct_norm as tdn
from repro_torch.kernels import gram_norm as tgn

RTOL = 1e-5

# (B, S, p_in, p_out) of the main path's launches (llama3.2-1b, B=8, S=512:
# wq/wo, w1/w3, w2, wk/wv) and of the LM head
MAIN = [(8, 512, 2048, 2048), (8, 512, 2048, 8192), (8, 512, 8192, 2048),
        (8, 512, 2048, 512)]
HEAD = (8, 512, 2048, 128256)


def _cover(plan, b, s, p_in, p_out):
    """Each (example, pair, tensor) unit's ranges, in segment order."""
    seen = {}
    for ex, pair, seg, tensor, c0, c1 in plan.work:
        seen.setdefault((ex, pair, tensor), []).append((seg, c0, c1))
    return seen


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("shape", MAIN + [HEAD])
def test_plan_visits_every_unit_once(shape, triangular):
    """Every (example, pair, range) is one block; each tensor's ranges tile
    its chunks without a gap or an overlap, at most MAX_CHUNKS long; h's
    segments come before z̄'s; the pairs' weights cover the n_s² grid; the
    scratch holds one 128 × 128 f32 tile per (example, pair, segment)."""
    b, s, p_in, p_out = shape
    plan = tgn.plan(b, s, p_in, p_out, triangular)
    n_s = -(-s // tgn.TILE_S)
    assert n_s == 4
    grid = np.zeros((n_s, n_s))
    for ti, tj, w in plan.pairs:
        grid[ti, tj] += 1 if triangular else w
        if triangular:
            assert w == (1 if ti == tj else 2) and ti <= tj
            grid[tj, ti] += w - 1
    assert (grid == 1).all()
    assert len(plan.pairs) == (10 if triangular else 16)
    units = _cover(plan, b, s, p_in, p_out)
    assert len(plan.work) == len(set(plan.work))
    assert len(units) == b * len(plan.pairs) * 2
    chunks = (-(-p_in // tgn.CHUNK), -(-p_out // tgn.CHUNK))
    for (ex, pair, tensor), ranges in units.items():
        segs = [seg for seg, _, _ in ranges]
        n = plan.n_h if tensor == 0 else plan.n_z
        first = 0 if tensor == 0 else plan.n_h
        assert segs == list(range(first, first + n))
        bounds = [c for _, c0, c1 in ranges for c in (c0, c1)]
        assert bounds[0] == 0 and bounds[-1] == chunks[tensor]
        assert bounds[1:-1:2] == bounds[2::2]          # no gap, no overlap
        assert all(0 < c1 - c0 <= tgn.MAX_CHUNKS for _, c0, c1 in ranges)
    assert plan.gram_shape(b) == (b, len(plan.pairs), plan.n_seg,
                                  128 * 128)
    assert plan.partials == len(plan.pairs) * tgn.SLABS
    assert len(plan.flat()) == 6 * len(plan.work) + 3 * len(plan.pairs)


def test_plan_at_the_paths_shapes():
    """The splits the cost model picks for 132 SMs at B=8, S=512, and the
    scratch they take: wq/wo run one range per tensor (160 blocks), w1/w3
    and w2 cut the wide tensor in two (240 blocks), the head cuts z̄ into
    17 ranges (1,440 blocks, 94 MB of partial Grams)."""
    want = {(2048, 2048): (1, 1), (2048, 8192): (1, 2), (8192, 2048): (2, 1),
            (2048, 512): (2, 1), (2048, 128256): (1, 17)}
    for b, s, p_in, p_out in MAIN + [HEAD]:
        plan = tgn.plan(b, s, p_in, p_out)
        assert (plan.n_h, plan.n_z) == want[p_in, p_out]
        assert len(plan.work) == b * 10 * plan.n_seg
    head = tgn.plan(*HEAD)
    assert np.prod(head.gram_shape(8)) * 4 == 94_371_840
    # the rows of one (example, range) run all ten pairs back to back
    rows = head.work[:10]
    assert [r[1] for r in rows] == list(range(10))
    assert len({(r[0], r[2]) for r in rows}) == 1


def test_split_counts_fill_the_card():
    """A range is at most MAX_CHUNKS chunks; with one SM a split only adds
    work, so a unit short enough keeps one range per tensor; with a
    thousand SMs the same unit is cut to fill them."""
    n_h, n_z = tgn.split_counts(1, 1000, 3000, sms=132)
    assert -(-1000 // n_h) <= tgn.MAX_CHUNKS >= -(-3000 // n_z)
    assert tgn.split_counts(1, 100, 100, sms=1) == (1, 1)
    n_h, n_z = tgn.split_counts(1, 100, 100, sms=1024)
    assert n_h > 1 and n_z > 1


def test_make_plan_rejects_ranges_past_the_chunks():
    with pytest.raises(ValueError):
        tgn.make_plan(1, 64, 64, 64, True, 2, 1)


def test_direct_tiles():
    """The direct launch's grid: 128 × 256 columns of G per bf16 block,
    128 × 128 per f32 block; the LM head is 16 × 501 bf16 blocks an
    example."""
    assert tdn.tiles(2048, 128256, torch.bfloat16) == (16, 501)
    assert tdn.tiles(2048, 128257, torch.bfloat16) == (16, 502)
    assert tdn.tiles(2048, 512, torch.bfloat16) == (16, 2)
    assert tdn.tiles(2048, 512, torch.float32) == (16, 4)
    assert tdn.tiles(1, 1, torch.bfloat16) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_copy_route_rule(dtype):
    """TMA where the base and every stride but the last are multiples of 16
    bytes: contiguous rows 8 bf16 wide, a batch slice of such rows; else
    the staged route: a base shifted by one element, an odd row pitch."""
    x = torch.zeros(4, 40, 64, dtype=dtype)
    assert _build.copy_route(x, x[1:3]) == "tma"
    assert _build.copy_route(x[:, :, 8:40]) == "tma"
    assert _build.copy_route(x[:, :, 1:]) == "synchronous"
    assert _build.copy_route(x, x[:, :, 1:]) == "synchronous"
    odd = torch.zeros(4, 40, 37, dtype=dtype)
    assert _build.copy_route(odd) == "synchronous"
    assert _build.copy_route(x[:, ::2]) == "tma"       # sequence stride 2


# ---------------------------------------------------------------------------
# the gram kernel's decomposition, in plain torch
# ---------------------------------------------------------------------------

def decomposition_model(h, z, plan):
    """What the bf16 gram kernel computes, launch by launch, in f32: each
    work row's partial Gram tile (its pair's two 128-row tiles over its
    chunk range, zero past S and past p), each pair's partials summed in
    segment order into G_H and G_Z, the fold Σ G_H ⊙ G_Z in SLABS slabs
    times the pair's weight, and each example's slab partials summed in
    order."""
    b, s, _ = h.shape
    tile, chunk = tgn.TILE_S, tgn.CHUNK
    rows = -(-s // tile) * tile

    def padded(x):
        p = -(-x.shape[2] // chunk) * chunk
        out = torch.zeros(b, rows, p, dtype=torch.float32)
        out[:, :s, :x.shape[2]] = x.float()
        return out
    xs = (padded(h), padded(z))
    grams = torch.zeros(plan.gram_shape(b))
    for ex, pair, seg, tensor, c0, c1 in plan.work:
        ti, tj, _ = plan.pairs[pair]
        x = xs[tensor][ex, :, c0 * chunk:c1 * chunk]
        a = x[ti * tile:(ti + 1) * tile]
        bt = x[tj * tile:(tj + 1) * tile]
        grams[ex, pair, seg] = (a @ bt.T).reshape(-1)
    out = torch.zeros(b)
    for ex in range(b):
        partial = []
        for pair, (_, _, w) in enumerate(plan.pairs):
            g = grams[ex, pair]
            gh, gz = g[0].clone(), g[plan.n_h].clone()
            for k in range(1, plan.n_h):
                gh += g[k]
            for k in range(plan.n_h + 1, plan.n_seg):
                gz += g[k]
            prod = (gh * gz).reshape(tgn.SLABS, -1)
            partial += [w * prod[k].sum() for k in range(tgn.SLABS)]
        out[ex] = torch.stack(partial).sum()
    return out


# (B, S, p_in, p_out, n_h, n_z): ragged S over one, two and three 128-row
# tiles, ragged feature axes over several 64-feature chunks, and plans that
# cut each tensor into several ranges (the ranges are uneven where the
# chunks do not divide)
MODEL_CASES = [(2, 37, 80, 200, 1, 1), (1, 150, 70, 130, 2, 3),
               (2, 300, 200, 130, 4, 1), (1, 257, 40, 333, 1, 6)]


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("case", MODEL_CASES)
def test_decomposition_matches_reference(case, triangular):
    """The decomposition against the reference's Pallas kernel (interpret
    mode, as ``test_gram_norm_matches_reference`` runs it), f32 1e-5."""
    b, s, p_in, p_out, n_h, n_z = case
    rng = np.random.default_rng(11)
    h = rng.normal(size=(b, s, p_in)).astype(np.float32)
    z = rng.normal(size=(b, s, p_out)).astype(np.float32)
    want = np.asarray(jops.gram_norm(jnp.asarray(h), jnp.asarray(z),
                                     triangular=triangular))
    plan = tgn.make_plan(b, s, p_in, p_out, triangular, n_h, n_z)
    got = decomposition_model(torch.from_numpy(h), torch.from_numpy(z), plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# ---------------------------------------------------------------------------
# what the Python side shares with csrc/
# ---------------------------------------------------------------------------

def _constant(source, name):
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_match_the_sources():
    """The launchers' tiles, chunk and fold slabs are the kernels'."""
    assert _constant("gram_norm.cu", "kRowsB") == tgn.TILE_S
    assert _constant("gram_norm.cu", "kChunkB") == tgn.CHUNK
    assert _constant("gram_norm.cu", "kWorkCols") == 6
    assert _constant("gram_norm.cu", "kPairCols") == 3
    assert (_constant("direct_norm.cu", "kInB"),
            _constant("direct_norm.cu", "kOutB")) == tdn.TILE[torch.bfloat16]
    assert (_constant("direct_norm.cu", "kTileIn"),
            _constant("direct_norm.cu", "kTileOut")) == \
        tdn.TILE[torch.float32]


@pytest.mark.parametrize("name", ["gram_norm_launch", "direct_norm_launch"])
def test_norm_launches_take_their_route_from_the_launcher(name):
    """Each norm launch takes the copy route as an argument (``tma``), as
    the flash launches do; the gram launch also takes the plan."""
    text = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    params = [p.strip() for p in m.group(1).split(",")]
    assert "int tma" in params
    if name == "gram_norm_launch":
        assert "const int* plan" in params
