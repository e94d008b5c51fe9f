"""Segmented norm kernel: per segment ||Σ_{t∈seg} h_t z̄_tᵀ||_F².

Port of ``src/repro/kernels/segmented_norm.py`` to CUDA kernels written
for Hopper (``csrc/segmented_norm.cu``). The MoE expert taps need the norm
over the rows of a capacity buffer: row t belongs to segment seg(t), and
segment j's partial gradient is G_j = Σ_{t: seg(t)=j} h_t z̄_tᵀ, whose
squared norm is also Σ_{t,t'∈j} <h_t,h_t'> <z̄_t,z̄_t'>.

What bounds the function on the H100 is bytes: the path's segments (one
per (group, expert, example)) hold a few dozen rows, where the gram form
is ~57× less arithmetic than the direct form and the function needs
little more than one read of the kept rows. So the launcher owns a plan
(:func:`plan`) that sends each segment to the form with the fewer
operations, and the kernels compute it:

- As in the reference, the segment scatter becomes a sort: :func:`csr`
  orders the rows by segment key (a stable argsort on the device) and
  turns the sorted keys into CSR offsets. Rows whose key lies outside
  ``[0, n_seg)`` (capacity padding, dropped tokens) go to a drop bucket
  after the last segment and are never read. The kernels read rows
  through the sort's permutation; no sorted copy of h or z̄ is made.
- The plan routes a segment of n rows to the gram form when that form,
  counted over 64-row tile pairs, needs fewer operations than the direct
  one (:func:`takes_gram`: the rule of ``ops.flop_estimate`` on a
  (1, n, p) problem), else to the direct form. It cuts each gram-route
  segment into 64-row tiles of its sorted rows and lists one work item per
  (segment, tile pair ti ≤ tj) with the pair's weight (2 off the diagonal,
  1 on it), and lists the direct-route segments. It is built from the
  offsets with device ops only: the segments' sizes index a route table
  of every size up to T made once per shape, running sums give each
  segment's items and direct slot, and a ``searchsorted`` gives each item
  its segment. The lists' lengths stay in device memory; the host sizes
  the scratch from static bounds (:func:`limits`), so the launch path
  makes no host sync.
- The gram route (bf16): a persistent grid of one-warpgroup blocks walks
  the items; each computes the two 64 × 64 Grams of its pair on ``wgmma``
  over 64-feature chunks copied by ``cp.async`` through the permutation
  into a ring of swizzled stages, folds Σ G_H ⊙ G_Z in registers and
  writes one partial. Each Gram is summed in chains of :data:`CHAIN`
  chunks whose sums are added in f32, so its error does not grow with the
  width. f32 inputs take the same items on the FMA pipes.
- The direct route: one block per (128-wide p_in tile, 128-wide p_out
  tile) walks the direct list and keeps its tile of G_j in registers
  (bf16 on ``mma.sync``, f32 on the FMA pipes).
- A last launch sums each segment's partials in a fixed order: no
  atomics, the same bits on every run. An empty segment reads 0.

Not carried over: the TPU wrapper's 128-lane padding of T, p_in and p_out
and its six scalar-prefetched (blk, r0, r1, seg, first, last) run tables;
ragged edges are masked at the load.

:func:`segmented_norm_ref` beside it is the plain version;
``kernels.ops.segmented_norm`` picks between the two by the tensors'
device.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gram_norm as _gn

_F32 = torch.float32
_I32 = torch.int32

#: rows of a gram-route tile (``kSegRows`` in csrc/segmented_norm.cu):
#: wgmma's m64, and the tile over which the route rule counts the gram form
TILE_ROWS = _gn.BOUND_TILE_S
#: features of a chunk of the bf16 gram body (``kChunk``)
CHUNK = 64
#: chunks a tensor-core chain of the bf16 gram body sums before its sum is
#: added in f32 (``kChain``): the error stays that of 256 features however
#: wide the rows
CHAIN = 4
#: p_in and p_out columns of G per direct-route block (``kTile``)
DIRECT_TILE = 128
#: int32 columns of a work item (``kItemCols``): segment, ti, tj, weight
ITEM_COLS = 4
#: rows of the plan's ``ends`` (``kEndRows``): running counts of gram
#: items, gram segments and direct segments
END_ROWS = 3
#: resident blocks per SM of the bf16 gram body (``kGramBlocks``): the
#: persistent grid is this many blocks per SM, or fewer when a launch can
#: have fewer items
BLOCKS_PER_SM = 4


def drop_bucket(seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """int64 segment keys with every id outside [0, n_seg) sent to the
    drop bucket ``n_seg``."""
    seg = seg_ids.long()
    return torch.where((seg < 0) | (seg >= n_seg),
                       torch.full_like(seg, n_seg), seg)


def csr(seg_ids: torch.Tensor, n_seg: int):
    """(order, offsets): ``order`` (T,) int32 lists the rows sorted by
    segment key (stable); segment j owns sorted positions
    ``[offsets[j], offsets[j+1])`` of it, and ``offsets[n_seg]`` is the
    number of rows that are not dropped. Device ops only, no host sync.
    The keys are sorted as int32 (n_seg < 2³¹): a radix sort of them takes
    half the passes of int64 keys."""
    key = drop_bucket(seg_ids, n_seg).to(_I32)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n_seg + 1, device=key.device, dtype=_I32)
    offsets = torch.searchsorted(key[order], bounds, out_int32=True)
    return order.to(_I32), offsets


def segmented_norm_ref(h: torch.Tensor, zbar: torch.Tensor,
                       seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Plain version: stable sort by key, then one f32 matmul
    ``H_segᵀ Z̄_seg`` per segment, squared and summed. h (T, p_in),
    zbar (T, p_out), seg_ids (T,) int → (n_seg,) f32."""
    order, offsets = csr(seg_ids, n_seg)
    h = h[order.long()].to(_F32)
    z = zbar[order.long()].to(_F32)
    bounds = offsets.tolist()
    out = torch.zeros((n_seg,), dtype=_F32, device=h.device)
    for j in range(n_seg):
        r0, r1 = bounds[j], bounds[j + 1]
        if r1 > r0:
            g = h[r0:r1].t() @ z[r0:r1]
            out[j] = torch.sum(torch.square(g))
    return out


def segment_sizes(seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(n_seg,) int64: the rows each segment keeps (dropped rows count in
    none)."""
    return torch.bincount(drop_bucket(seg_ids, n_seg),
                          minlength=n_seg + 1)[:n_seg]


# ---------------------------------------------------------------------------
# the route of a segment, and the plan
# ---------------------------------------------------------------------------

def tiles(n):
    """64-row tiles of a segment of ``n`` rows (an int or an array)."""
    return -(-n // TILE_ROWS)


def takes_gram(n, p_in: int, p_out: int):
    """Whether a segment of ``n`` rows (an int or an int64 array) takes the
    gram route: it is not empty and the gram form over 64-row tile pairs,
    (n² + Σ_i r_i²)·(p_in + p_out + 1) with r_i the tiles' rows
    (``gram_norm.bound_flop_estimate``), is fewer operations than the
    direct form, 2·(n + 1)·p_in·p_out (``direct_norm.flop_estimate``):
    the fewer form of ``ops.flop_estimate`` on a (1, n, p) problem. A tie
    takes the direct route."""
    full, rest = n // TILE_ROWS, n % TILE_ROWS
    gram = (n * n + TILE_ROWS * TILE_ROWS * full + rest * rest) \
        * (p_in + p_out + 1)
    return (n > 0) & (gram < 2 * (n + 1) * p_in * p_out)


def pair_rows(n_tiles: int) -> list:
    """(ti, tj, weight) of the tile pairs ti ≤ tj of ``n_tiles`` tiles,
    ordered by tj, then ti: the pairs of a segment of t tiles are the first
    t·(t+1)/2 rows."""
    return [(i, j, 1 if i == j else 2) for j in range(n_tiles)
            for i in range(j + 1)]


@dataclasses.dataclass(frozen=True)
class Limits:
    """Static bounds of a launch on T rows, n_seg segments and these widths,
    which the host sizes the plan and the scratch from."""
    max_tiles: int    # tiles of the longest segment that can take gram
    items: int        # the most gram items
    directs: int      # the most direct-route segments

    @property
    def gram(self) -> bool:
        return self.items > 0


def route_table(t: int, p_in: int, p_out: int) -> np.ndarray:
    """(END_ROWS, t + 1) int32, per segment size n = 0..t: its gram items
    (t(n)·(t(n)+1)/2 on the gram route, else 0), 1 if it takes the gram
    route, 1 if it takes the direct route."""
    n = np.arange(t + 1, dtype=np.int64)
    gram = takes_gram(n, p_in, p_out)
    k = tiles(n)
    return np.stack([np.where(gram, k * (k + 1) // 2, 0), gram,
                     (n > 0) & ~gram]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def limits(t: int, n_seg: int, p_in: int, p_out: int) -> Limits:
    """The bounds for T = ``t`` rows. A gram segment of t_j ≤ t* tiles has
    t_j·(t_j+1)/2 = 1 + (t_j−1)·(t_j+2)/2 pairs, and the segments' t_j − 1
    sum to at most T // 64 (each tile past a segment's first holds 64 of
    its rows), so the items are at most min(n_seg, T) + (T // 64)·(t*+2)/2.
    A direct segment holds at least the fewest rows that take the direct
    route, n_d, so there are at most min(n_seg, T // n_d)."""
    n = np.arange(t + 1, dtype=np.int64)
    _, gram, direct = route_table(t, p_in, p_out).astype(bool)
    max_tiles = int(tiles(n[gram]).max()) if gram.any() else 0
    items = (min(n_seg, t) + (t // TILE_ROWS) * (max_tiles + 2) // 2
             if max_tiles else 0)
    directs = min(n_seg, t // int(n[direct].min())) if direct.any() else 0
    return Limits(max_tiles, items, directs)


@functools.lru_cache(maxsize=64)
def _tables(t: int, n_seg: int, p_in: int, p_out: int, device) -> tuple:
    """The plan's constant tables on ``device``, made once per shape: the
    route table, the pair rows of the longest gram segment, and the item and
    direct-slot indices."""
    lim = limits(t, n_seg, p_in, p_out)
    return (torch.tensor(route_table(t, p_in, p_out), device=device),
            torch.tensor(pair_rows(lim.max_tiles), dtype=_I32,
                         device=device).reshape(-1, 3),
            torch.arange(lim.items, dtype=_I32, device=device),
            torch.arange(lim.directs, dtype=_I32, device=device))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's schedule, as the kernels read it. The lists are as long
    as :func:`limits` allows; their used lengths stay on the device."""
    items: torch.Tensor   # (limits.items, 4) int32: segment, ti, tj, weight
    ends: torch.Tensor    # (3, n_seg) int32: running counts of gram items,
                          # gram segments, direct segments
    direct: torch.Tensor  # (limits.directs,) int32: direct segments' ids

    @property
    def n_items(self) -> torch.Tensor:
        """Gram items in use (the first rows of ``items``)."""
        return self.ends[0, -1]

    @property
    def n_direct(self) -> torch.Tensor:
        """Direct segments listed (the first entries of ``direct``)."""
        return self.ends[2, -1]


def plan(offsets: torch.Tensor, t: int, p_in: int, p_out: int) -> Plan:
    """The plan of a launch on T = ``t`` rows from the CSR ``offsets``
    (n_seg + 1,) int32 of :func:`csr`, on offsets' device, by device ops
    only. Item k lies in the segment whose items' running count first
    exceeds k; its pair is row k − (the segment's first item) of
    :func:`pair_rows`. Rows past the used length hold values in range that
    no kernel reads."""
    n_seg = offsets.numel() - 1
    table, pairs, k, d = _tables(t, n_seg, p_in, p_out, offsets.device)
    flags = table[:, offsets[1:] - offsets[:-1]]
    ends = torch.cumsum(flags, 1, dtype=_I32)
    seg = torch.searchsorted(ends[0], k, right=True, out_int32=True)
    seg.clamp_(max=n_seg - 1)
    first = (ends[0] - flags[0])[seg]
    q = (k - first).clamp_(0, pairs.shape[0] - 1)
    items = torch.cat((seg[:, None], pairs[q]), 1)
    direct = torch.searchsorted(ends[2], d, right=True, out_int32=True)
    return Plan(items, ends, direct)


def flop_estimate(seg_ids: torch.Tensor, n_seg: int, p_in: int,
                  p_out: int) -> float:
    """Operations the kernels do on the data, by the route each segment
    takes: a gram segment's tile pairs at the bf16 body's 64 rows and
    64-feature chunks (both 64 × 64 Grams and their fold, padding
    included); a direct segment's H_jᵀZ̄_j (2·n·p_in·p_out) and its
    square-and-sum (2·p_in·p_out). ``kernels.ops.segmented_flop_estimate``
    gives the fewest the function needs."""
    feats = CHUNK * (-(-p_in // CHUNK) + -(-p_out // CHUNK))
    per_pair = 2.0 * TILE_ROWS * TILE_ROWS * (feats + 1)
    total = 0.0
    for n in segment_sizes(seg_ids, n_seg).tolist():
        if takes_gram(n, p_in, p_out):
            total += tiles(n) * (tiles(n) + 1) // 2 * per_pair
        elif n:
            total += 2.0 * n * p_in * p_out + 2.0 * p_in * p_out
    return total


def bytes_estimate(seg_ids: torch.Tensor, n_seg: int, p_in: int, p_out: int,
                   itemsize: int) -> float:
    """The kept rows of h and z̄ read once (dropped rows are never read),
    the T segment ids read once and the n_seg f32 norms written once."""
    n_valid = int(segment_sizes(seg_ids, n_seg).sum())
    return float(n_valid * (p_in + p_out) * itemsize
                 + seg_ids.numel() * seg_ids.element_size() + 4 * n_seg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

#: launches of each route's kernel, by copy route as the launcher passed it
#: ("cp.async" or "synchronous" for bf16, "fma" for f32): {("gram" or
#: "direct", copy): launches}
route_launches = collections.Counter()
#: per device, the (2,) counts of gram and direct segments of each launch
#: since :func:`reset_route_counts`: views of its plan's ``ends``, left on
#: the device, so a launch adds no device op for them; every FOLD_ROUTES
#: launches a device's list is summed into one entry on the device
_segments = collections.defaultdict(list)
FOLD_ROUTES = 256


def reset_route_counts() -> None:
    route_launches.clear()
    _segments.clear()


def route_segments() -> dict:
    """{"gram": segments, "direct": segments} over the launches since
    :func:`reset_route_counts` (waits for them)."""
    total = sum((c.long().cpu() for counts in _segments.values()
                 for c in counts), torch.zeros(2, dtype=torch.int64))
    return {"gram": int(total[0]), "direct": int(total[1])}


@functools.lru_cache(maxsize=16)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_info() -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the bf16 gram body, as the CUDA
    runtime reports them."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.load().segmented_norm_kernel_info(out),
                 "segmented_norm_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


def segmented_norm(h: torch.Tensor, zbar: torch.Tensor,
                   seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Launch the CUDA kernels. h (T, p_in), zbar (T, p_out), both float32
    or both bfloat16, on one CUDA device, any row strides (a copy is made
    only when the feature axis is not contiguous); seg_ids (T,) int; no
    extent 0 and n_seg ≥ 1 → (n_seg,) float32."""
    if h.device.type != "cuda" or zbar.device != h.device \
            or seg_ids.device != h.device:
        raise ValueError(f"segmented_norm: the kernel takes CUDA tensors on "
                         f"one device, got {h.device}, {zbar.device} and "
                         f"{seg_ids.device}")
    if h.ndim != 2 or zbar.ndim != 2 or seg_ids.shape != h.shape[:1] \
            or zbar.shape[0] != h.shape[0]:
        raise ValueError(f"segmented_norm: expected h (T, p_in), zbar "
                         f"(T, p_out) and seg_ids (T,), got {tuple(h.shape)}, "
                         f"{tuple(zbar.shape)} and {tuple(seg_ids.shape)}")
    if h.dtype != zbar.dtype:
        raise TypeError(f"segmented_norm: h and zbar differ in dtype "
                        f"({h.dtype} vs {zbar.dtype})")
    if h.numel() == 0 or zbar.numel() == 0 or n_seg < 1:
        raise ValueError("segmented_norm: empty input; "
                         "``kernels.ops.segmented_norm`` answers it without "
                         "a launch")
    dtype = _build.dtype_code(h)
    if h.stride(-1) != 1:
        h = h.contiguous()
    if zbar.stride(-1) != 1:
        zbar = zbar.contiguous()
    t, p_in = h.shape
    p_out = zbar.shape[1]
    dev = h.device
    order, offsets = csr(seg_ids, n_seg)
    p = plan(offsets, t, p_in, p_out)
    lim = limits(t, n_seg, p_in, p_out)
    if h.dtype == torch.bfloat16:
        copy = "cp.async" if _build.aligned_rows(h, zbar) else "synchronous"
    else:
        copy = "fma"
    lib = _build.load()
    gram_partial = torch.empty((lim.items,), dtype=_F32, device=dev)
    direct_partial = torch.empty(
        (lim.directs, lib.segmented_norm_tiles(p_in, p_out)), dtype=_F32,
        device=dev)
    out = torch.empty((n_seg,), dtype=_F32, device=dev)
    blocks = min(lim.items, BLOCKS_PER_SM * _sms(dev))
    code = lib.segmented_norm_launch(
        h.data_ptr(), zbar.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        p.items.data_ptr(), p.ends.data_ptr(), p.direct.data_ptr(),
        gram_partial.data_ptr(), direct_partial.data_ptr(), out.data_ptr(),
        dtype, n_seg, p_in, p_out, h.stride(0), zbar.stride(0), blocks,
        int(lim.directs > 0), int(copy == "cp.async"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "segmented_norm")
    if lim.gram:
        route_launches["gram", copy] += 1
    if lim.directs:
        route_launches["direct", copy] += 1
    counts = _segments[dev]
    counts.append(p.ends[1:, -1])
    if len(counts) >= FOLD_ROUTES:
        counts[:] = [torch.stack([c.long() for c in counts]).sum(0)]
    return out
