"""Tile-pair Gram kernel: per-example ||H_jᵀZ̄_j||_F² without the S×S Gram.

Port of ``src/repro/kernels/gram_norm.py`` to a CUDA kernel written for
Hopper (``csrc/gram_norm.cu``; the note at its top says what bounds it and
what the design does about that). The identity

    s_j = Σ_{t,t'} <h_t, h_t'> <z̄_t, z̄_t'>

is evaluated tile pair by tile pair. For bf16 inputs the launcher owns the
schedule (:func:`plan`): pairs of 128-row sequence tiles, each tensor's
feature axis cut into ranges of 64-feature chunks, one CUDA block per
(example, pair, range) that accumulates its partial Gram tile on the tensor
cores and writes it to scratch; a second launch sums each pair's partial
H-Grams and Z-Grams in a fixed order and folds them, a third sums each
example's pairs. ``triangular=True`` (the default) visits only the upper
triangle and weights off-diagonal pairs by 2; ``triangular=False`` visits
the full grid and is the regression oracle for that halving. f32 inputs run
on the FMA pipes, one block per pair of 64-row tiles.

The launcher also decides each bf16 launch's copy route
(:func:`repro_torch.kernels._build.copy_route`: TMA where the rows allow a
tensor map, staging by loads and stores otherwise) and counts it in
:data:`route_launches`.

What the TPU wrapper did that the port does not: zero-padding S and the
feature axes to 128-lane tiles (``ops.py``'s ``_launch_tiles``). The CUDA
kernel reads ragged edges as zero instead.

The plain version is :func:`repro_torch.kernels.ref.gram_norm_ref`;
``kernels.ops.gram_norm`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

#: sequence rows of a tile of the bf16 body (``kRowsB`` in csrc/gram_norm.cu)
TILE_S = 128
#: features of a chunk, the unit of a feature range (``kChunkB``)
CHUNK = 64
#: rows of the tiles over which the bound counts the gram form's work (see
#: :func:`bound_flop_estimate`); not a tile of either body
BOUND_TILE_S = 64
#: most chunks in one block's range: the tensor cores' accumulation chain
#: (8,192 features); the ranges are summed in f32 by the fold
MAX_CHUNKS = 128
#: fold blocks per pair (each sums 1/SLABS of the 128 x 128 tile)
SLABS = 8
#: f32 entries of a partial Gram tile
GRAM_ELEMS = TILE_S * TILE_S
#: the plan's price of one block beyond its chunks (its first copies and its
#: store), and of one block's scratch round trip, in chunk-times
_PROLOGUE_CHUNKS = 4.0
_SCRATCH_CHUNKS = 0.08
#: H100 SXM; the launcher passes the device's own count
SMS = 132


def _pair_work(s: int, p_in: int, p_out: int, tile: int,
               triangular: bool) -> float:
    """Multiply-adds ×2 of the two Gram tiles and the fold over every
    visited pair of ``tile``-row tiles, a ragged last tile at its true
    height."""
    n = -(-s // tile)
    rows = [min(tile, s - i * tile) for i in range(n)]
    work = 0.0
    for i in range(n):
        for j in range(i if triangular else 0, n):
            work += 2.0 * rows[i] * rows[j] * (p_in + p_out + 1)
    return work


def flop_estimate(b: int, s: int, p_in: int, p_out: int, *,
                  triangular: bool = True) -> float:
    """Multiply-adds ×2 the bf16 kernel does on a logical (b, s, p)
    problem: the two Gram tiles of every visited pair of its 128-row tiles
    plus the fold."""
    return float(b) * _pair_work(s, p_in, p_out, TILE_S, triangular)


def bound_flop_estimate(b: int, s: int, p_in: int, p_out: int) -> float:
    """The gram form's work as a bound counts it: the triangle of
    ``BOUND_TILE_S``-row tile pairs, a fixed count that does not follow
    either body's tile, so a new kernel tile leaves every bound as it
    was."""
    return float(b) * _pair_work(s, p_in, p_out, BOUND_TILE_S, True)


# ---------------------------------------------------------------------------
# the bf16 body's schedule (csrc/gram_norm.cu: gram_partial_wgmma, gram_fold)
# ---------------------------------------------------------------------------

def pair_table(s: int, triangular: bool = True) -> list:
    """(ti, tj, weight) of every pair of 128-row tiles a launch visits: the
    upper triangle row by row, an off-diagonal pair standing in for its
    mirror twin (weight 2), or the full n_s × n_s grid (weight 1)."""
    n = -(-s // TILE_S)
    if triangular:
        return [(i, j, 1 if i == j else 2) for i in range(n)
                for j in range(i, n)]
    return [(i, j, 1) for i in range(n) for j in range(n)]


def chunk_ranges(chunks: int, parts: int) -> list:
    """``chunks`` chunks cut into ``parts`` consecutive ranges (c0, c1) whose
    lengths differ by at most one."""
    return [(k * chunks // parts, (k + 1) * chunks // parts)
            for k in range(parts)]


def split_counts(units: int, c_h: int, c_z: int, sms: int = SMS) -> tuple:
    """(n_h, n_z): the ranges into which h's ``c_h`` and z̄'s ``c_z`` chunks
    are cut, for ``units`` (example, pair) units. Each candidate range
    length L ≤ MAX_CHUNKS gives ceil(c/L) ranges per tensor; the plan takes
    the one with the least modelled time: waves of one block per SM, each
    as long as its longest range plus a prologue, and the scratch round
    trip of every block."""
    best = None
    for length in range(1, MAX_CHUNKS + 1):
        n_h, n_z = -(-c_h // length), -(-c_z // length)
        longest = max(-(-c_h // n_h), -(-c_z // n_z))
        blocks = units * (n_h + n_z)
        cost = (-(-blocks // sms) * (longest + _PROLOGUE_CHUNKS)
                + _SCRATCH_CHUNKS * blocks)
        key = (cost, blocks)
        if best is None or key < best[0]:
            best = (key, (n_h, n_z))
    return best[1]


@dataclasses.dataclass(frozen=True)
class Plan:
    """A bf16 launch's schedule, as the kernel reads it."""
    pairs: tuple        # (ti, tj, weight) per pair
    work: tuple         # (b, pair, segment, tensor, c0, c1) per block
    n_h: int            # ranges of h: segments 0 .. n_h - 1
    n_z: int            # ranges of z̄: segments n_h .. n_h + n_z - 1

    @property
    def n_seg(self) -> int:
        return self.n_h + self.n_z

    def gram_shape(self, b: int) -> tuple:
        """Shape of the partial Gram scratch, f32."""
        return (b, len(self.pairs), self.n_seg, GRAM_ELEMS)

    @property
    def partials(self) -> int:
        """Slab partials per example (the third launch's row)."""
        return len(self.pairs) * SLABS

    def flat(self) -> list:
        """The work rows, then the pair rows, as one int list."""
        return [v for row in self.work + self.pairs for v in row]


def make_plan(b: int, s: int, p_in: int, p_out: int, triangular: bool,
              n_h: int, n_z: int) -> Plan:
    """The schedule with h's chunks cut into ``n_h`` ranges and z̄'s into
    ``n_z``. The work rows run, per example and range, all pairs back to
    back: the n_s row tiles they share are read from device memory once and
    from L2 after that."""
    pairs = pair_table(s, triangular)
    c_h, c_z = -(-p_in // CHUNK), -(-p_out // CHUNK)
    if not (1 <= n_h <= c_h and 1 <= n_z <= c_z):
        raise ValueError(f"{n_h} and {n_z} ranges do not fit {c_h} and "
                         f"{c_z} chunks")
    work = []
    for ex in range(b):
        seg = 0
        for tensor, chunks, parts in ((0, c_h, n_h), (1, c_z, n_z)):
            for c0, c1 in chunk_ranges(chunks, parts):
                work += [(ex, k, seg, tensor, c0, c1)
                         for k in range(len(pairs))]
                seg += 1
    return Plan(tuple(pairs), tuple(work), n_h, n_z)


@functools.lru_cache(maxsize=64)
def plan(b: int, s: int, p_in: int, p_out: int, triangular: bool = True,
         sms: int = SMS) -> Plan:
    """The schedule of a bf16 launch on (b, s, p_in, p_out): the ranges
    :func:`split_counts` picks for ``sms`` SMs."""
    n_pairs = len(pair_table(s, triangular))
    n_h, n_z = split_counts(b * n_pairs, -(-p_in // CHUNK),
                            -(-p_out // CHUNK), sms)
    return make_plan(b, s, p_in, p_out, triangular, n_h, n_z)


@functools.lru_cache(maxsize=64)
def _device_plan(b, s, p_in, p_out, triangular, device):
    """:func:`plan` for the device's SM count, and its :meth:`Plan.flat`
    as an int32 tensor on ``device``; made once per shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = plan(b, s, p_in, p_out, triangular, sms)
    return p, torch.tensor(p.flat(), dtype=torch.int32, device=device)


#: bf16 launches by copy route, as the launcher passed it: {("gram",
#: route): launches}
route_launches = collections.Counter()


def kernel_info() -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the bf16 body, as the CUDA
    runtime reports them."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.load().gram_norm_kernel_info(out),
                 "gram_norm_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


def gram_norm(h: torch.Tensor, zbar: torch.Tensor, *,
              triangular: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. h (B, S, p_in), zbar (B, S, p_out), both
    float32 or both bfloat16, on one CUDA device, any batch and sequence
    strides (a copy is made only when the feature axis is not contiguous),
    no extent 0 → (B,) float32."""
    h, zbar = _build.pair_inputs(h, zbar, "gram_norm")
    if h.numel() == 0 or zbar.numel() == 0:
        raise ValueError("gram_norm: empty input; ``kernels.ops.gram_norm`` "
                         "answers it without a launch")
    b, s, p_in = h.shape
    p_out = zbar.shape[-1]
    out = torch.empty((b,), dtype=torch.float32, device=h.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    args = (_build.dtype_code(h), b, s, p_in, p_out, h.stride(0),
            h.stride(1), zbar.stride(0), zbar.stride(1), int(triangular))
    if h.dtype == torch.bfloat16:
        route = _build.copy_route(h, zbar)
        route_launches["gram", route] += 1
        p, table = _device_plan(b, s, p_in, p_out, triangular, h.device)
        grams = torch.empty(p.gram_shape(b), dtype=torch.float32,
                            device=h.device)
        partial = torch.empty((b, p.partials), dtype=torch.float32,
                              device=h.device)
        code = lib.gram_norm_launch(
            h.data_ptr(), zbar.data_ptr(), grams.data_ptr(),
            partial.data_ptr(), out.data_ptr(), *args, int(route == "tma"),
            table.data_ptr(), len(p.work), len(p.pairs),
            p.n_h, p.n_z, SLABS, stream)
    else:
        n_pairs = lib.gram_norm_blocks(s, int(triangular))
        partial = torch.empty((b, n_pairs), dtype=torch.float32,
                              device=h.device)
        code = lib.gram_norm_launch(
            h.data_ptr(), zbar.data_ptr(), None, partial.data_ptr(),
            out.data_ptr(), *args, 0, None, 0, n_pairs, 0, 0, 0, stream)
    _build.check(code, "gram_norm")
    return out
