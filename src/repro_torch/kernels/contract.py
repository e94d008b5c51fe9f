"""Launch contracts — each CUDA kernel's launch as checkable data, for
Hopper.

Port of ``src/repro/kernels/contract.py``, rewritten for the H100: the
reference described a Pallas launch by its grid and its VMEM blocks against
a TPU core's budget; a CUDA launch is described by its grid, the threads of
a block, the dynamic shared memory a block takes and the blocks the kernel
asks to keep resident on an SM (its ``__launch_bounds__``), the registers a
thread where they are known, every TMA descriptor it encodes, every
``wgmma`` shape it issues, and the divisibility its indexing assumes.
``validate`` checks a contract *without launching it* against the card's
budgets (NVIDIA's limits for the H100, compute capability 9.0):

  * a block: ≤ 232,448 B of shared memory and ≤ 1,024 threads, and the
    resident blocks' shared memory within the SM's 233,472 B;
  * registers: ≤ 255 a thread, and ≤ 65,536 an SM across the blocks it
    keeps;
  * the grid: x < 2³¹, y and z ≤ 65,535;
  * TMA: a global base aligned to 16 B, strides that are multiples of
    16 B, box extents of at most 256, a box row of a multiple of 16 B;
  * ``wgmma``: M a multiple of 64, N a multiple of 8 from 8 to 256, a K
    of 32 bytes;
  * every accumulator in f32 (``ACCUMULATOR_DTYPE``, the reference's rule:
    bf16 accumulation loses the low bits of exactly the squared-norm sums
    the paper's exactness claim rests on).

The contract describes the launch the wrapper in ``kernels.ops`` would
issue — the launcher's own plan, tiles and grid (the functions there take
them from ``gram_norm.plan``, ``direct_norm.tiles``,
``segmented_norm.limits`` / ``direct_depth`` and
``flash_attention.dkv_work``) — not the logical shapes. On the card,
``check_info`` holds a contract against what the CUDA runtime reports for
the built kernel (``kernel_info()``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

#: the H100's budgets (compute capability 9.0)
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
THREADS_PER_BLOCK = 1_024
REGS_PER_THREAD = 255
REGS_PER_SM = 65_536
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65_535
TMA_BOX_MAX = 256
TMA_ALIGN = 16
WGMMA_M = 64
WGMMA_N_MAX = 256
WGMMA_K_BYTES = 32

#: every partial-sum accumulator must be of this dtype
ACCUMULATOR_DTYPE = torch.float32

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4, "int64": 8}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


@dataclasses.dataclass(frozen=True)
class Buffer:
    """One buffer a block keeps: ``where`` "smem" (a region of its dynamic
    shared memory) or "regs" (held in registers across the launch, e.g. a
    tensor-core accumulator). ``accumulator`` marks partial sums, held to
    the f32 rule."""
    name: str
    shape: Tuple[int, ...]
    dtype: object
    where: str = "smem"
    accumulator: bool = False

    @property
    def bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class TmaDesc:
    """One tensor map the launcher encodes: the global base's offset in
    bytes from an allocation (the caching allocator aligns allocations to
    256 B), the strides in bytes of every dimension past the first, the
    box extents in elements (first dimension contiguous) and the element
    size."""
    name: str
    base_offset: int
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    elem_bytes: int


@dataclasses.dataclass(frozen=True)
class Wgmma:
    """One ``wgmma.mma_async`` shape a warpgroup issues."""
    m: int
    n: int
    k: int
    in_dtype: object
    acc_dtype: object = torch.float32


@dataclasses.dataclass(frozen=True)
class Divisibility:
    """One ``extent % tile == 0`` assumption of the kernel's indexing."""
    axis: str
    extent: int
    tile: int

    @property
    def ok(self) -> bool:
        return self.tile >= 1 and self.extent >= 0 \
            and self.extent % self.tile == 0


@dataclasses.dataclass(frozen=True)
class LaunchContract:
    """The checkable surface of one kernel launch.

    ``smem_bytes`` is the dynamic shared memory a block asks for (static
    ``__shared__`` scratch of a few words is not counted);
    ``blocks_per_sm`` the resident blocks its launch bounds ask for (1
    where it names none); ``registers`` the registers a thread, where known.

    ``flops`` and ``bytes`` are what the cost passes read (``hbm_bytes()``):
    the fewest operations the wrapper's function needs on the launch's
    operands and the bytes it must move, each input read once and each
    output written once — the rows a launch keeps, counted as the bounds
    of PERF.md §6 and ``kernels.ops.gram_cost`` / ``direct_cost`` count
    them, not the traffic of the kernel's own tiles. The launch's roofline
    time is then max(flops / peak, bytes / HBM rate). Where one wrapper
    call launches two kernels (the segmented routes), the call's work and
    bytes ride on its first contract."""
    kernel: str
    grid: Tuple[int, ...]
    threads: int
    smem_bytes: int = 0
    blocks_per_sm: int = 1
    registers: Optional[int] = None
    buffers: Tuple[Buffer, ...] = ()
    tma: Tuple[TmaDesc, ...] = ()
    wgmma: Tuple[Wgmma, ...] = ()
    divisibility: Tuple[Divisibility, ...] = ()
    flops: float = 0.0
    bytes: float = 0.0

    def hbm_bytes(self) -> float:
        """Bytes the launch must move through HBM (see the class note)."""
        return float(self.bytes)


def validate(contract: LaunchContract) -> list:
    """All violations of one contract (empty ⇒ the launch is well-formed
    for the H100). Checked statically."""
    c = contract
    errors = []
    for i, g in enumerate(c.grid):
        limit = GRID_X_MAX if i == 0 else GRID_YZ_MAX
        if not 1 <= int(g) <= limit:
            errors.append(f"{c.kernel}: grid axis {i} has extent {g}, "
                          f"outside [1, {limit}] (grid={c.grid})")
    if not 1 <= c.threads <= THREADS_PER_BLOCK:
        errors.append(f"{c.kernel}: {c.threads} threads a block; the card "
                      f"takes 1 to {THREADS_PER_BLOCK}")
    if c.smem_bytes > SMEM_PER_BLOCK:
        errors.append(f"{c.kernel}: {c.smem_bytes} B of shared memory a "
                      f"block exceeds the {SMEM_PER_BLOCK} B a block can "
                      f"use — buffers: " + ", ".join(
                          f"{b.name}{b.shape}:{dtype_name(b.dtype)}"
                          for b in c.buffers if b.where == "smem"))
    if c.blocks_per_sm * c.smem_bytes > SMEM_PER_SM:
        errors.append(f"{c.kernel}: {c.blocks_per_sm} resident blocks of "
                      f"{c.smem_bytes} B exceed the SM's {SMEM_PER_SM} B "
                      f"of shared memory")
    smem = sum(b.bytes for b in c.buffers if b.where == "smem")
    if smem > c.smem_bytes:
        errors.append(f"{c.kernel}: its shared-memory buffers take {smem} "
                      f"B, more than the {c.smem_bytes} B it asks for")
    if c.registers is not None:
        if c.registers > REGS_PER_THREAD:
            errors.append(f"{c.kernel}: {c.registers} registers a thread "
                          f"exceed {REGS_PER_THREAD}")
        if c.registers * c.threads * c.blocks_per_sm > REGS_PER_SM:
            errors.append(f"{c.kernel}: {c.blocks_per_sm} blocks of "
                          f"{c.threads} threads at {c.registers} registers "
                          f"exceed the SM's {REGS_PER_SM}")
    for t in c.tma:
        if t.base_offset % TMA_ALIGN:
            errors.append(f"{c.kernel}: TMA map {t.name!r} has a global "
                          f"base {t.base_offset} B off an aligned "
                          f"allocation, not a multiple of {TMA_ALIGN} B")
        for s in t.strides:
            if s % TMA_ALIGN:
                errors.append(f"{c.kernel}: TMA map {t.name!r} has a "
                              f"stride of {s} B, not a multiple of "
                              f"{TMA_ALIGN} B")
        if any(not 1 <= b <= TMA_BOX_MAX for b in t.box):
            errors.append(f"{c.kernel}: TMA map {t.name!r} has box "
                          f"{t.box}; every extent must lie in [1, "
                          f"{TMA_BOX_MAX}]")
        if t.box and (t.box[0] * t.elem_bytes) % TMA_ALIGN:
            errors.append(f"{c.kernel}: TMA map {t.name!r} has a box row "
                          f"of {t.box[0] * t.elem_bytes} B, not a multiple "
                          f"of {TMA_ALIGN} B")
    for w in c.wgmma:
        if w.m % WGMMA_M:
            errors.append(f"{c.kernel}: wgmma M={w.m} is not a multiple "
                          f"of {WGMMA_M}")
        if w.n % 8 or not 8 <= w.n <= WGMMA_N_MAX:
            errors.append(f"{c.kernel}: wgmma N={w.n} is not a multiple "
                          f"of 8 in [8, {WGMMA_N_MAX}]")
        if w.k * itemsize(w.in_dtype) != WGMMA_K_BYTES:
            errors.append(f"{c.kernel}: wgmma K={w.k} of "
                          f"{dtype_name(w.in_dtype)} is not "
                          f"{WGMMA_K_BYTES} bytes")
        if dtype_name(w.acc_dtype) != dtype_name(ACCUMULATOR_DTYPE):
            errors.append(f"{c.kernel}: wgmma accumulates in "
                          f"{dtype_name(w.acc_dtype)}; partial sums must "
                          f"accumulate in "
                          f"{dtype_name(ACCUMULATOR_DTYPE)}")
    for d in c.divisibility:
        if not d.ok:
            errors.append(f"{c.kernel}: {d.axis}={d.extent} is not "
                          f"divisible by its tile {d.tile} — the launcher's "
                          f"schedule disagrees with the kernel's indexing")
    for b in c.buffers:
        if b.accumulator and dtype_name(b.dtype) != \
                dtype_name(ACCUMULATOR_DTYPE):
            errors.append(f"{c.kernel}: accumulator {b.name!r} has dtype "
                          f"{dtype_name(b.dtype)}; partial sums must "
                          f"accumulate in "
                          f"{dtype_name(ACCUMULATOR_DTYPE)}")
    return errors


def check_info(contract: LaunchContract, info: dict) -> list:
    """Disagreements between a contract and a built kernel's
    ``kernel_info()`` reading (registers, local_bytes, smem_bytes, threads,
    blocks_per_sm): the shared memory and threads must be the contract's,
    the registers within the budget, and the resident blocks at least the
    contract's."""
    c = contract
    errors = []
    if info["smem_bytes"] != c.smem_bytes:
        errors.append(f"{c.kernel}: contract states {c.smem_bytes} B of "
                      f"shared memory a block, the kernel takes "
                      f"{info['smem_bytes']} B")
    if info["threads"] != c.threads:
        errors.append(f"{c.kernel}: contract states {c.threads} threads, "
                      f"the kernel launches {info['threads']}")
    regs = info["registers"]
    if regs > REGS_PER_THREAD:
        errors.append(f"{c.kernel}: {regs} registers a thread exceed "
                      f"{REGS_PER_THREAD}")
    if regs * info["threads"] * max(info["blocks_per_sm"], 1) > REGS_PER_SM:
        errors.append(f"{c.kernel}: {info['blocks_per_sm']} resident blocks "
                      f"at {regs} registers exceed the SM's {REGS_PER_SM}")
    if c.registers is not None and regs > c.registers:
        errors.append(f"{c.kernel}: {regs} registers a thread, the "
                      f"contract states at most {c.registers}")
    if info["blocks_per_sm"] < c.blocks_per_sm:
        errors.append(f"{c.kernel}: {info['blocks_per_sm']} resident blocks "
                      f"per SM, the launch bounds ask for "
                      f"{c.blocks_per_sm}")
    return errors
