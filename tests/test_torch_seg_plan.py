"""What surrounds the segmented norm kernels, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
Here: the route rule against the operation counts it stands for, the
launcher's plan (gram items and direct list, built by device ops from the
CSR offsets) on CPU tensors, the static bounds the launcher sizes its
scratch from, a plain-torch model of what the kernels compute from the
plan (per-item 64-row tile Grams and their weighted fold, per direct
segment the square of H_jᵀZ̄_j, then fixed-order sums) held against the
JAX reference's Pallas kernel in interpret mode at f32 1e-5 (summation
order), and the constants and entry point the Python side shares with
``csrc/segmented_norm.cu``.
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
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segmented_norm as tsn

RTOL = 1e-5

# (p_in, p_out): the MoE path's gate/up and down, chip_smoke's edge-case
# and wide widths, and the narrow and ragged widths of the cases below
WIDTHS = [(4096, 6400), (6400, 4096), (512, 384), (28672, 8192), (200, 136),
          (24, 40), (520, 700), (3, 5)]


def _crossover(p_in, p_out):
    """The first segment size that takes the direct route."""
    n = 1
    while tsn.takes_gram(n, p_in, p_out):
        n += 1
    return n


@pytest.mark.parametrize("widths", WIDTHS)
def test_route_is_the_fewer_form(widths):
    """A segment takes the gram route exactly where ``ops.flop_estimate``'s
    gram form (over 64-row tile pairs) is fewer operations than the direct
    form, on both sides of the crossover; the table the plan indexes says
    the same."""
    p_in, p_out = widths
    cross = _crossover(p_in, p_out)
    sizes = sorted({1, 2, 63, 64, 65, 128, 300, 3000} | set(
        range(max(1, cross - 70), cross + 70)))
    for n in sizes:
        gram = tgn.bound_flop_estimate(1, n, p_in, p_out)
        direct = tdn.flop_estimate(1, n, p_in, p_out)
        assert tops.flop_estimate(1, n, p_in, p_out) == min(gram, direct)
        assert bool(tsn.takes_gram(n, p_in, p_out)) == (gram < direct), n
    table = tsn.route_table(max(sizes), p_in, p_out)
    for n in sizes:
        gram = bool(tsn.takes_gram(n, p_in, p_out))
        t = tsn.tiles(n)
        assert list(table[:, n]) == [t * (t + 1) // 2 if gram else 0,
                                     gram, not gram]
    assert list(table[:, 0]) == [0, 0, 0]


def test_routes_at_the_paths_shapes():
    """Every MoE-path segment (at most a capacity slice of 88 rows) takes
    the gram route at gate/up and at down; chip_smoke's one segment of
    3,000 rows at 512 → 384 takes the direct route; its mixed case (512 →
    384, 1 to ~1,500 rows) has sizes on both sides; its wide case (28,672
    → 8,192) sends every segment to gram."""
    for p_in, p_out in ((4096, 6400), (6400, 4096)):
        assert all(tsn.takes_gram(n, p_in, p_out) for n in range(1, 89))
        assert _crossover(p_in, p_out) == 4932
    assert not tsn.takes_gram(3000, 512, 384)
    assert _crossover(512, 384) == 377
    # chip_smoke's wide case: ~77 rows a segment, all on gram
    assert all(tsn.takes_gram(n, 28672, 8192) for n in range(1, 300))


@pytest.mark.parametrize("widths", WIDTHS)
def test_limits_bound_every_layout(widths):
    """The static bounds hold for the layouts that come nearest them: every
    row its own segment, segments of one size at the gram route's longest
    and at the direct route's shortest, random segment sizes; and a
    width pair that sends no size to a route bounds it by 0."""
    p_in, p_out = widths
    cross = _crossover(p_in, p_out)
    longest = max(n for n in range(1, cross + 200)
                  if tsn.takes_gram(n, p_in, p_out))
    rng = np.random.default_rng(3)
    for t, n_seg in ((600, 700), (5000, 64), (22528, 512), (3000, 1)):
        lim = tsn.limits(t, n_seg, p_in, p_out)
        layouts = [np.ones(min(t, n_seg), np.int64),
                   np.full(min(n_seg, t // longest), longest),
                   np.full(min(n_seg, t // cross), cross),
                   rng.multinomial(t, np.ones(n_seg) / n_seg)]
        for sizes in layouts:
            sizes = np.asarray(sizes, np.int64)
            gram = tsn.takes_gram(sizes, p_in, p_out)
            k = tsn.tiles(sizes[gram])
            assert int((k * (k + 1) // 2).sum()) <= lim.items
            assert int(((sizes > 0) & ~gram).sum()) <= lim.directs
        assert lim.max_tiles == (tsn.tiles(min(longest, t)) if t else 0)
    assert tsn.limits(cross - 1, 8, p_in, p_out).directs == 0


def _ids(sizes, n_seg, drop, rng):
    """Segment ids giving segment j ``sizes[j]`` rows, with ``drop`` rows
    of ids outside [0, n_seg) among them, shuffled."""
    seg = np.concatenate([np.full(n, j) for j, n in enumerate(sizes)]
                         + [n_seg + rng.integers(0, 5, size=drop),
                            -1 - rng.integers(0, 3, size=drop // 2)])
    return rng.permutation(seg)


def _check_plan(seg, n_seg, p_in, p_out):
    t = seg.shape[0]
    _, offsets = tsn.csr(seg, n_seg)
    p = tsn.plan(offsets, t, p_in, p_out)
    lim = tsn.limits(t, n_seg, p_in, p_out)
    sizes = tsn.segment_sizes(seg, n_seg).numpy()
    gram = tsn.takes_gram(sizes, p_in, p_out)
    direct = (sizes > 0) & ~gram
    assert p.items.shape == (lim.items, tsn.ITEM_COLS)
    assert p.direct.shape == (lim.directs,)
    assert p.ends.shape == (tsn.END_ROWS, n_seg)
    assert p.items.dtype == p.ends.dtype == p.direct.dtype == torch.int32
    n_items, n_direct = int(p.n_items), int(p.n_direct)
    want = [(j, i, k, 1 if i == k else 2) for j in np.nonzero(gram)[0]
            for k in range(tsn.tiles(sizes[j])) for i in range(k + 1)]
    assert [tuple(r) for r in p.items[:n_items].tolist()] == want
    assert p.direct[:n_direct].tolist() == list(np.nonzero(direct)[0])
    assert p.ends[1, -1] == int(gram.sum())
    # each segment's items and direct slot, as segment_sums reads them
    first = np.concatenate([[0], p.ends[0, :-1].numpy()])
    for j in range(n_seg):
        items = p.items[first[j]:p.ends[0, j]]
        assert (items[:, 0] == j).all()
        t_j = tsn.tiles(sizes[j])
        assert len(items) == (t_j * (t_j + 1) // 2 if gram[j] else 0)
        slot = p.ends[2, j - 1] if j else 0
        assert bool(p.ends[2, j] > slot) == bool(direct[j])
        if direct[j]:
            assert p.direct[slot] == j
    return p, offsets, gram, direct


# (p_in, p_out, segment sizes, dropped rows, both routes): ragged widths
# with segments of 1, 63, 64, 65, 128 and 300 rows and empty ones between
# them (gram up to 107 rows there); wider rows, three chains of the bf16
# body's each, where 300 rows take gram over 15 tile pairs and 700 take
# direct; narrow rows whose crossover is 16
# rows; and no drops with every segment on gram
PLAN_CASES = [(200, 136, [1, 0, 63, 64, 0, 65, 128, 300, 0], 40, True),
              (520, 700, [300, 129, 2, 0, 700], 25, True),
              (24, 40, [1, 15, 16, 0, 63, 64, 65], 9, True),
              (64, 48, [5, 7, 0, 11], 0, False)]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_visits_every_pair_once(case):
    """The plan built on CPU tensors lists every (segment, tile pair ti ≤
    tj) of each gram-route segment once, in segment order, with weight 2
    off the diagonal; every direct-route segment once, in order; and its
    running counts give each segment its items and its direct slot."""
    p_in, p_out, sizes, drop, mixed = case
    rng = np.random.default_rng(5)
    seg = torch.from_numpy(_ids(sizes, len(sizes), drop, rng))
    _, _, gram, direct = _check_plan(seg, len(sizes), p_in, p_out)
    assert gram.any() and bool(direct.any()) == mixed


def test_plan_of_the_moe_path_layout():
    """The MoE path's layout (16 groups × 16 experts, capacity 88, two
    examples a group, ~28 rows a segment): every non-empty segment on the
    gram route, one item for each of up to 64 rows and three past that."""
    rng = np.random.default_rng(7)
    ng, e, cap, bg = 16, 16, 88, 2
    local = rng.integers(0, bg + 1, size=(ng, e, cap))   # bg: padding
    ge = (np.arange(ng)[:, None, None] * e + np.arange(e)[None, :, None])
    seg = np.where(local < bg, ge * bg + local, ng * e * bg)
    seg = torch.from_numpy(seg.reshape(-1))
    p, _, gram, direct = _check_plan(seg, ng * e * bg, 4096, 6400)
    assert not direct.any() and int(p.n_direct) == 0
    sizes = tsn.segment_sizes(seg, ng * e * bg).numpy()
    assert int(p.n_items) == int((sizes > 0).sum() + 2 * (sizes > 64).sum())


# ---------------------------------------------------------------------------
# what the kernels compute from the plan, in plain torch
# ---------------------------------------------------------------------------

def _tile_rows(x, order, r0, r1, tile):
    """The 64 rows of ``tile`` of a segment's sorted rows [r0, r1), rows
    past its end as zeros (the kernels' zero fill)."""
    pos = r0 + tile * tsn.TILE_ROWS + torch.arange(tsn.TILE_ROWS)
    rows = x[order[pos.clamp(max=x.shape[0] - 1)].long()]
    return torch.where((pos < r1)[:, None], rows, torch.zeros_like(rows))


def _chains(a, b):
    """The products a bᵀ of each chain of the bf16 gram body: CHAIN chunks
    of CHUNK features, the last one ragged."""
    step = tsn.CHAIN * tsn.CHUNK
    return [a[:, c:c + step] @ b[:, c:c + step].T
            for c in range(0, a.shape[1], step)]


def plan_model(h, z, order, offsets, p):
    """In f32: each item's weight × Σ (X_ti X_tjᵀ) ⊙ (Z̄_ti Z̄_tjᵀ), as the
    bf16 gram body sums it: G_H the sum of its chains, each chain of G_Z
    folded against G_H in turn; each listed direct segment's ||H_jᵀZ̄_j||²
    summed over 128 × 128 tiles of G in tile order; then each segment's
    item partials in item order, or its direct partials, or 0."""
    h, z = h.float(), z.float()
    off = offsets.tolist()
    partial = []
    for seg, ti, tj, w in p.items[:int(p.n_items)].tolist():
        r0, r1 = off[seg], off[seg + 1]
        gh = sum(_chains(_tile_rows(h, order, r0, r1, ti),
                         _tile_rows(h, order, r0, r1, tj)))
        gz = _chains(_tile_rows(z, order, r0, r1, ti),
                     _tile_rows(z, order, r0, r1, tj))
        fold = sum(torch.sum(gh * c) for c in gz)
        partial.append(w * fold)
    direct = []
    for seg in p.direct[:int(p.n_direct)].tolist():
        rows = order[off[seg]:off[seg + 1]].long()
        g = h[rows].T @ z[rows]
        tiles = [torch.sum(torch.square(g[i:i + tsn.DIRECT_TILE,
                                          k:k + tsn.DIRECT_TILE]))
                 for i in range(0, g.shape[0], tsn.DIRECT_TILE)
                 for k in range(0, g.shape[1], tsn.DIRECT_TILE)]
        direct.append(sum(tiles, torch.tensor(0.0)))
    n_seg = offsets.numel() - 1
    out = torch.zeros(n_seg)
    first = 0
    for j in range(n_seg):
        last = int(p.ends[0, j])
        slot = int(p.ends[2, j - 1]) if j else 0
        if last > first:
            out[j] = sum(partial[first:last], torch.tensor(0.0))
        elif int(p.ends[2, j]) > slot:
            out[j] = direct[slot]
        first = last
    return out


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_model_matches_reference(case):
    """The plan's plain model against the reference's Pallas kernel
    (interpret mode, as ``tests/test_segmented.py`` runs it), f32 1e-5;
    empty segments exactly 0."""
    p_in, p_out, sizes, drop, _ = case
    n_seg = len(sizes)
    rng = np.random.default_rng(9)
    seg = _ids(sizes, n_seg, drop, rng)
    t = seg.shape[0]
    h = rng.normal(size=(t, p_in)).astype(np.float32)
    z = rng.normal(size=(t, p_out)).astype(np.float32)
    want = np.asarray(jops.segmented_norm(
        jnp.asarray(h), jnp.asarray(z), jnp.asarray(seg, jnp.int32), n_seg))
    order, offsets = tsn.csr(torch.from_numpy(seg), n_seg)
    p = tsn.plan(offsets, t, p_in, p_out)
    got = plan_model(torch.from_numpy(h), torch.from_numpy(z), order,
                     offsets, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert (got.numpy()[np.asarray(sizes) == 0] == 0).all()


# ---------------------------------------------------------------------------
# what the Python side shares with csrc/
# ---------------------------------------------------------------------------

def _constant(name):
    text = (_build.CSRC / "segmented_norm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_match_the_source():
    """The plan's tile, chunk, chain, item and running-count layout and
    the persistent grid's blocks per SM are the kernels'."""
    assert _constant("kSegRows") == tsn.TILE_ROWS
    assert _constant("kChunk") == tsn.CHUNK
    assert _constant("kChain") == tsn.CHAIN
    assert _constant("kTile") == tsn.DIRECT_TILE
    assert _constant("kItemCols") == tsn.ITEM_COLS
    assert _constant("kEndRows") == tsn.END_ROWS
    assert _constant("kGramBlocks") == tsn.BLOCKS_PER_SM


def test_launch_takes_the_plan_and_route_from_the_launcher():
    """The C launch takes the plan's three tables, the gram grid, whether
    to run the direct kernel and the copy route as arguments; the kernels
    keep no rule of their own; its ctypes signature has one type per
    parameter."""
    text = (_build.CSRC / "segmented_norm.cu").read_text()
    m = re.search(r'extern "C" int segmented_norm_launch\(([^)]*)\)', text)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    for want in ("const void* items", "const void* ends",
                 "const void* dlist", "int gram_blocks", "int direct",
                 "int vec"):
        assert want in params
    assert len(_build._SIGNATURES["segmented_norm_launch"]) == len(params)
