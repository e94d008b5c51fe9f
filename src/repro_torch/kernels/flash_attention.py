"""Flash attention: causal GQA with an online softmax, forward and backward.

Port of ``src/repro/kernels/flash_attention.py`` to three CUDA kernels
written for Hopper (``csrc/flash_attention.cu``; the note at its top says
what bounds each and what the design does about it): the forward returns O
and the per-row log-sum-exp, the dQ kernel and the dK/dV kernel recompute
the probabilities from that lse. The (Sq, Sk) score matrix never reaches
device memory in either direction.

In bf16 the forward and the dQ kernel give each block two warpgroups and
128 query rows, longest rows first; Q (and dO) arrive once by TMA, the
64-key K/V tiles through a ring of TMA stages (``mbarrier`` completion:
the forward's three with one block barrier per tile, dQ's four with K and
V on barriers of their own and each stage released by the warps that read
it), and ``wgmma`` forms Q Kᵀ and P V (forward) or S = Q Kᵀ, dP = dO Vᵀ
and dS K (dQ); the softmax runs in base 2 and the mask is tested only on
tiles that cross the diagonal, the window's edge or the end of the keys;
O and dQ leave in 16-byte rows. The dK/dV kernel gives each block a pair
of 64-key tiles, ``x`` and ``n - 1 - x`` (:func:`dkv_key_tiles`), so that
every block walks the same number of q tiles under the causal mask, brings
the rep q heads' Q and dO through a ring of the same kind, and splits the
queries between its two warpgroups, whose dK and dV it sums in a fixed
order. Rows that TMA cannot describe are staged by loads and stores
instead (:func:`copy_route`). The launchers here own both choices: each
passes its route to the kernel, and the dK/dV launcher its blocks' key
tiles and q-tile ranges (:func:`dkv_work`, a small table cached in device
memory per shape); :data:`route_launches` counts the bf16 launches of each
route. The f32 kernels keep their first form (FMA pipes).

Layout is the reference's: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), with
Hq a multiple of Hkv (query head h reads kv head h // rep). The kernels take
any batch, head and sequence strides with D contiguous, so the model passes
its (B, S, H, D) projections as transposed views, and they mask ragged Sq
and Sk themselves: unlike the TPU wrapper, nothing here pads to a block
multiple. D is 32, 64 or 128; any other head dim raises.

Beside each launcher is its plain PyTorch version (explicit f32 einsums
over the whole score matrix): ``flash_attention_fwd_ref``,
``flash_attention_bwd_dq_ref``, ``flash_attention_bwd_dkv_ref`` and
``flash_attention_bwd_ref`` for all three gradients (the formulas of
``flash_attention.py:216-221``). ``kernels.ops`` picks between the two by
the tensors' device. Δ = rowsum(dO ⊙ O) stays a torch expression
(:func:`row_delta`), as it stays outside Pallas in the reference.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_F32 = torch.float32
NEG_INF = -1.0e30      # the reference's finite mask value
HEAD_DIMS = (32, 64, 128)
KEY_TILE = 64          # keys of a staged tile; rows of a dQ / dK/dV q tile


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, scale, softcap, window):
    """Masked (softcapped) f32 scores (B, Hq, Sq, Sk), the mask, and the
    softcap's chain factor (None without one)."""
    rep = q.shape[1] // k.shape[1]
    kf = k.to(_F32).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_F32), kf) * scale
    chain = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        chain = 1.0 - t * t
    qpos = torch.arange(q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask, s, NEG_INF), mask, chain


def _group_sum(x, hkv):
    """(B, Hq, S, D) → (B, Hkv, S, D): sum each kv head's rep q heads."""
    b, hq, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2)


def flash_attention_fwd_ref(q, k, v, *, scale: float,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None):
    """Plain version of the forward: (O like q, lse (B, Hq, Sq) f32)."""
    s, _, _ = _scores(q, k, scale, softcap, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    rep = q.shape[1] // k.shape[1]
    vf = v.to(_F32).repeat_interleave(rep, dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, vf)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, scale, softcap, window):
    s, mask, chain = _scores(q, k, scale, softcap, window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    rep = q.shape[1] // k.shape[1]
    vf = v.to(_F32).repeat_interleave(rep, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(_F32), vf)
    ds = p * (dp - delta[..., None])
    if chain is not None:
        ds = ds * chain
    return p, torch.where(mask, ds, 0.0)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *, scale: float,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None):
    """Plain version of the dQ kernel: dQ = scale·dS K, like q."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, softcap, window)
    rep = q.shape[1] // k.shape[1]
    kf = k.to(_F32).repeat_interleave(rep, dim=1)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, scale: float,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None):
    """Plain version of the dK/dV kernel: (dK = scale·dSᵀQ, dV = PᵀdO),
    each summed over its kv head's q heads, like k and v."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, softcap, window)
    hkv = k.shape[1]
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(_F32)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(_F32))
    return (_group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype))


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in f32, (B, Hq, Sq)."""
    return torch.sum(do.to(_F32) * o.to(_F32), dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None):
    """Plain version of the backward: (dQ, dK, dV) from the forward's O and
    lse and the output cotangent dO."""
    delta = row_delta(o, do)
    kw = dict(scale=scale, softcap=softcap, window=window)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# work of each function: only the (query, key) pairs the mask keeps
# ---------------------------------------------------------------------------

def causal_pairs(sq: int, sk: int, window: Optional[int] = None) -> int:
    """(query, key) pairs with key ≤ query, key < sk and, with a window,
    query − key < window: the pairs any of the three functions must
    compute, per (batch, q head)."""
    total = 0
    for i in range(sq):
        first = 0 if window is None else max(0, i - window + 1)
        total += max(0, min(i, sk - 1) - first + 1)
    return total


#: matrix products per causal pair and head dim, each 2 flops a term:
#: forward QKᵀ and PV; dQ recomputes QKᵀ and forms dO Vᵀ and dS K; dK/dV
#: recomputes QKᵀ and dO Vᵀ and forms PᵀdO and dSᵀQ
PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def flop_estimate(kind: str, b: int, hq: int, sq: int, sk: int, d: int,
                  window: Optional[int] = None) -> float:
    """Matrix-product operations of ``kind`` ("fwd", "dq" or "dkv") over
    the causal pairs."""
    return (2.0 * PRODUCTS[kind] * b * hq * causal_pairs(sq, sk, window)
            * d)


def byte_estimate(kind: str, b: int, hq: int, hkv: int, sq: int, sk: int,
                  d: int, itemsize: int) -> float:
    """Bytes ``kind`` must move, each input read once and each output
    written once: q, k, v (+ dO, lse, Δ for the backward) in; O and lse,
    dQ, or dK and dV out. lse and Δ are f32."""
    q_bytes = b * hq * sq * d * itemsize
    kv_bytes = b * hkv * sk * d * itemsize
    row_bytes = b * hq * sq * 4
    if kind == "fwd":
        return float(q_bytes + 2 * kv_bytes + q_bytes + row_bytes)
    ins = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes     # q, dO, k, v, lse, Δ
    if kind == "dq":
        return float(ins + q_bytes)
    return float(ins + 2 * kv_bytes)


# ---------------------------------------------------------------------------
# the bf16 kernels' schedule and copy route (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def query_tiles(k0: int, sq: int, sk: int,
                window: Optional[int] = None) -> range:
    """The 64-row q tiles holding a query that sees some key of the 64-key
    tile starting at ``k0``: those a dK/dV block walks for that tile."""
    q_end = sq
    if window is not None:
        q_end = min(q_end, min(k0 + KEY_TILE, sk) - 1 + window)
    return range(k0 // KEY_TILE, -(-q_end // KEY_TILE))


def dkv_key_tiles(sk: int) -> list:
    """The 64-key tiles each dK/dV block owns, per (batch, kv head), in the
    order it walks them: block x takes tile x and then tile n − 1 − x, n =
    ceil(sk / 64); the middle tile of an odd n is a block's alone. Under
    the causal mask tile t meets n − t q tiles, so every pair meets n + 1.
    """
    n = -(-sk // KEY_TILE)
    return [(x,) if x == n - 1 - x else (x, n - 1 - x)
            for x in range((n + 1) // 2)]


def dkv_work(sq: int, sk: int, window: Optional[int] = None) -> list:
    """The bf16 dK/dV kernel's schedule, one row per block: (key tile,
    first q tile, end q tile) for each of its two key tiles
    (:func:`dkv_key_tiles`, :func:`query_tiles`), the middle tile of an odd
    count given twice. The launcher passes these rows to the kernel."""
    rows = []
    for tiles in dkv_key_tiles(sk):
        row = []
        for t in (tiles[0], tiles[-1]):
            r = query_tiles(t * KEY_TILE, sq, sk, window)
            row += [t, r.start, r.stop]
        rows.append(tuple(row))
    return rows


@functools.lru_cache(maxsize=64)
def _work_table(sq, sk, window, device):
    """:func:`dkv_work` as an int32 tensor on ``device``, made once per
    shape."""
    return torch.tensor(dkv_work(sq, sk, window), dtype=torch.int32,
                        device=device)


#: the copy route of the bf16 kernels' inputs (the rule all bf16 kernels
#: share): TMA where every base and (batch, head, sequence) stride is a
#: multiple of 16 bytes, else synchronous staging
copy_route = _build.copy_route


#: bf16 launches of the forward ("fwd"), dQ ("dq") and dK/dV ("dkv")
#: kernels by copy route, as the launchers passed it: {(kind, route):
#: launches}
route_launches = collections.Counter()


def _route(kind, dtype, *tensors) -> int:
    """The copy route of a launch (1 for TMA), counted; f32 has none."""
    if dtype != torch.bfloat16:
        return 0
    route = copy_route(*tensors)
    route_launches[kind, route] += 1
    return int(route == "tma")


def kernel_info(kind: str, d: int) -> dict:
    """Registers, local memory bytes per thread, dynamic shared memory,
    threads and resident blocks per SM of the bf16 kernel ``kind`` ("fwd",
    "dq" or "dkv") at head dim ``d`` without a softcap, as the CUDA runtime
    reports them (the registers and local bytes are those ``nvcc -Xptxas
    -v`` prints for the kernel)."""
    out = (ctypes.c_int * 5)()
    code = _build.load().flash_attention_kernel_info(
        ("fwd", "dq", "dkv").index(kind), d, out)
    _build.check(code, "flash_attention_kernel_info")
    return dict(zip(_build.INFO_KEYS, out))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _inputs(what, q, k, v, *more):
    """Check q, k, v (and dO, shaped like q) for the kernels and return
    them with D contiguous (a copy only where it was not)."""
    ts = (q, k, v) + more
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(f"{what}: the kernel takes CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.ndim != 4 for t in ts):
        raise ValueError(f"{what}: expected q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {[tuple(t.shape) for t in ts]}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{what}: shapes do not fit together: "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: inputs differ in dtype "
                        f"{[t.dtype for t in ts]}")
    _build.dtype_code(q)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} is not one the kernel is "
                         f"built for {HEAD_DIMS}")
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{what}: {hq} q heads do not split into groups "
                         f"over {hkv} kv heads")
    if b == 0 or hq == 0 or sq == 0 or sk == 0:
        raise ValueError(f"{what}: empty input {[tuple(t.shape) for t in ts]}")
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _rows(t, like, what):
    """lse or Δ: (B, Hq, Sq) f32 on q's device, contiguous."""
    if t.shape != like.shape[:3] or t.dtype != _F32 or t.device != like.device:
        raise ValueError(f"{what}: expected a {tuple(like.shape[:3])} float32 "
                         f"tensor on {like.device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def _options(softcap, window):
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return (0.0 if softcap is None else float(softcap),
            0 if window is None else int(window))


def _sizes(q, k):
    b, hq, sq, d = q.shape
    return b, hq, k.shape[1], sq, k.shape[2], d


def flash_attention_fwd(q, k, v, *, scale: float,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None):
    """Launch the forward kernel → (O like q, lse (B, Hq, Sq) f32)."""
    q, k, v = _inputs("flash_attention", q, k, v)
    cap, win = _options(softcap, window)
    b, hq, hkv, sq, sk, d = _sizes(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=_F32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _build.load().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _build.dtype_code(q), b, hq, hkv, sq, sk, d,
        float(scale), cap, win, _build.strides_arg((q, k, v, o)),
        _route("fwd", q.dtype, q, k, v), stream)
    _build.check(code, "flash_attention")
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Launch the dQ kernel → dQ like q."""
    q, k, v, do = _inputs("flash_attention_bwd_dq", q, k, v, do)
    lse = _rows(lse, q, "flash_attention_bwd_dq lse")
    delta = _rows(delta, q, "flash_attention_bwd_dq delta")
    cap, win = _options(softcap, window)
    b, hq, hkv, sq, sk, d = _sizes(q, k)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _build.load().flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _build.dtype_code(q), b, hq, hkv, sq, sk, d, float(scale), cap, win,
        _build.strides_arg((q, k, v, do, dq)),
        _route("dq", q.dtype, q, k, v, do), stream)
    _build.check(code, "flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None):
    """Launch the dK/dV kernel → (dK like k, dV like v)."""
    q, k, v, do = _inputs("flash_attention_bwd_dkv", q, k, v, do)
    lse = _rows(lse, q, "flash_attention_bwd_dkv lse")
    delta = _rows(delta, q, "flash_attention_bwd_dkv delta")
    cap, win = _options(softcap, window)
    b, hq, hkv, sq, sk, d = _sizes(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    work = (_work_table(sq, sk, window, q.device)
            if q.dtype == torch.bfloat16 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _build.load().flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _build.dtype_code(q), b, hq, hkv, sq, sk, d, float(scale), cap, win,
        _build.strides_arg((q, k, v, do, dk, dv)),
        _route("dkv", q.dtype, q, k, v, do),
        None if work is None else work.data_ptr(),
        0 if work is None else work.shape[0], stream)
    _build.check(code, "flash_attention_bwd_dkv")
    return dk, dv
