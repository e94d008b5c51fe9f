"""RWKV6 ("Finch") — attention-free time-mix with data-dependent decay.

Port of ``src/repro/nn/rwkv.py``. Per head (dim N):
state S ∈ ℝ^{N×N};

    o_t = r_t · (S_{t-1} + diag(u)·k_t v_tᵀ)
    S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ

with w_t = exp(-exp(w0 + tanh(x w1) w2)) — the data-dependent decay LoRA —
and ddlerp token-shift mixing for the r/k/v/g/w streams. Every matrix
parameter is tapped where the reference taps it (``mix_a``, the five
``mix_b`` slices, r/k/v/g/o, the decay LoRA, ``ln_x`` and the channel
mix); the per-channel vectors (μ's, w0, u) are trained but outside the pex
scope (``models.registry.UNTAPPED_ALLOWLIST``).

The WKV recurrence holds no tap. It runs in f32, with the reference's
expressions in its order (``_wkv_step``), over chunks of ``CHUNK`` time
steps (``wkv``): the forward keeps only each chunk's first state, and the
backward recomputes a chunk's states from it and runs the reverse
recurrence by hand, so the saved state is S/CHUNK states and not S. The
forward gives the bits of the plain per-step loop (``wkv_loop``, which
autograd differentiates step by step).

Decode is the same recurrence from a carried state: ``init_rwkv_state``
holds each layer's last time-mix and channel-mix rows (the token shift of
the next segment) and the f32 wkv matrix; with a ``state``, ``rwkv_tmix``
and ``rwkv_cmix`` read it and write the segment's final rows and matrix
back into it in place (``wkv_from``: the per-step body of ``wkv_loop``
from the given matrix).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Tap
from repro_torch.nn import param as pm
from repro_torch.nn.linear import init_linear, linear
from repro_torch.nn.norms import init_layernorm, layernorm

#: time steps of each chunk of the WKV recurrence (the backward keeps one
#: state per chunk and recomputes the chunk's others)
CHUNK = 64


@dataclasses.dataclass(frozen=True)
class RwkvCfg:
    d_model: int
    d_ff: int
    head_dim: int = 64
    mix_lora: int = 32
    decay_lora: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


_STREAMS = 5  # r, k, v, g, w


def init_rwkv_tmix(gen: torch.Generator, cfg: RwkvCfg, *, dtype, device):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "mu": pm.zeros((_STREAMS + 1, d), dtype, device),
        "mix_a": init_linear(gen, d, _STREAMS * cfg.mix_lora, std=0.02,
                             **kw),
        "mix_b": pm.normal(gen, (_STREAMS, cfg.mix_lora, d), dtype, device,
                           std=0.02),
        "wr": init_linear(gen, d, d, **kw),
        "wk": init_linear(gen, d, d, **kw),
        "wv": init_linear(gen, d, d, **kw),
        "wg": init_linear(gen, d, d, **kw),
        "wo": init_linear(gen, d, d, **kw),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "decay_a": init_linear(gen, d, cfg.decay_lora, std=0.02, **kw),
        "decay_b": init_linear(gen, cfg.decay_lora, d, std=0.02, **kw),
        "u": pm.zeros((d,), torch.float32, device),
        "ln_x": init_layernorm(d, **kw),
    }


def init_rwkv_cmix(gen: torch.Generator, cfg: RwkvCfg, *, dtype, device):
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "mu": pm.zeros((2, d), dtype, device),
        "wk": init_linear(gen, d, cfg.d_ff, **kw),
        "wr": init_linear(gen, d, d, **kw),
        "wv": init_linear(gen, cfg.d_ff, d, **kw),
    }


def init_rwkv_state(batch: int, cfg: RwkvCfg, *, dtype, device):
    """One layer's decode state: the token-shift rows ``tm_shift`` and
    ``cm_shift`` (B, d) in ``dtype`` and the wkv matrix (B, nh, hd, hd) in
    f32, all zero."""
    d = cfg.d_model
    return {"tm_shift": torch.zeros(batch, d, dtype=dtype, device=device),
            "cm_shift": torch.zeros(batch, d, dtype=dtype, device=device),
            "wkv": torch.zeros(batch, cfg.n_heads, cfg.head_dim,
                               cfg.head_dim, dtype=torch.float32,
                               device=device)}


def _token_shift(x: torch.Tensor, prev=None) -> torch.Tensor:
    """xx_t = x_{t-1}; before the first token ``prev`` (B, d), the last row
    of the previous segment, or zero (training: no previous segment)."""
    first = x.new_zeros(x.shape[0], 1, x.shape[2]) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_step(state, r_t, k_t, v_t, w_t, u):
    """One step of the reference's scan body: (B,nh,hd) inputs, state
    (B,nh,hd,hd), u (nh,hd) → (new state, o_t (B,nh,hd))."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o_t = torch.einsum("bhk,bhkv->bhv", r_t, state + u[None, :, :, None] * kv)
    return w_t[..., :, None] * state + kv, o_t


def wkv_from(r, k, v, w, u, state):
    """The plain per-step loop from ``state`` (B,nh,hd,hd) f32: r, k, v, w
    (B,S,nh,hd) f32, u (nh,hd) → (o (B,S,nh,hd), the final state)."""
    outs = []
    for t in range(r.shape[1]):
        state, o_t = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(o_t)
    return torch.stack(outs, dim=1), state


def wkv_loop(r, k, v, w, u):
    """The plain per-step loop from a zero state: r, k, v, w (B,S,nh,hd)
    f32, u (nh,hd) → o (B,S,nh,hd). Autograd keeps every step's state."""
    b, _, nh, hd = r.shape
    return wkv_from(r, k, v, w, u, r.new_zeros(b, nh, hd, hd))[0]


class _Wkv(torch.autograd.Function):
    """``wkv_loop`` over chunks of ``chunk`` steps, keeping each chunk's
    first state (the second output, not differentiable) for the backward,
    which recomputes the chunk's states from it and runs the reverse
    recurrence by hand. Pure tensor ops with ``setup_context``, so
    ``torch.func`` transforms (the naive oracle's ``vmap(grad)``) run it
    through the generated vmap rule."""
    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, v, w, u, chunk):
        b, s, nh, hd = r.shape
        state = r.new_zeros(b, nh, hd, hd)
        outs, starts = [], []
        for t in range(s):
            if t % chunk == 0:
                starts.append(state)
            state, o_t = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t],
                                   u)
            outs.append(o_t)
        return torch.stack(outs, dim=1), torch.stack(starts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, chunk = inputs
        ctx.save_for_backward(r, k, v, w, u, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, do, _):
        r, k, v, w, u, starts = ctx.saved_tensors
        chunk = ctx.chunk
        s = r.shape[1]
        uu = u[None, :, :, None]
        ds = torch.zeros_like(starts[0])     # ∂L/∂S_t from the steps after t
        du = torch.zeros_like(u)
        grads = [[None] * s for _ in range(4)]
        for c in reversed(range(starts.shape[0])):
            t0, t1 = c * chunk, min(s, (c + 1) * chunk)
            prev, state = [], starts[c]
            for t in range(t0, t1):          # S_{t-1} for each step
                prev.append(state)
                state, _ = _wkv_step(state, r[:, t], k[:, t], v[:, t],
                                     w[:, t], u)
            for t in reversed(range(t0, t1)):
                sp = prev[t - t0]
                r_t, k_t, v_t, w_t, do_t = (r[:, t], k[:, t], v[:, t],
                                            w[:, t], do[:, t])
                kv = k_t[..., :, None] * v_t[..., None, :]
                dp = r_t[..., :, None] * do_t[..., None, :]   # ∂L/∂(S+u·kv)
                dkv = uu * dp + ds
                grads[0][t] = torch.einsum("bhv,bhkv->bhk", do_t, sp + uu * kv)
                grads[1][t] = torch.einsum("bhkv,bhv->bhk", dkv, v_t)
                grads[2][t] = torch.einsum("bhkv,bhk->bhv", dkv, k_t)
                grads[3][t] = torch.sum(ds * sp, dim=-1)
                du = du + torch.sum(dp * kv, dim=(0, 3))
                ds = dp + w_t[..., :, None] * ds
        dr, dk, dv, dw = (torch.stack(g, dim=1) for g in grads)
        return dr, dk, dv, dw, du, None


def wkv(r, k, v, w, u):
    """The WKV recurrence from a zero state over chunks of ``CHUNK`` steps
    (see ``_Wkv``): the bits of :func:`wkv_loop`, with S/CHUNK saved states
    instead of S."""
    return _Wkv.apply(r, k, v, w, u, CHUNK)[0]


# ---------------------------------------------------------------------------
# the time mix and the channel mix
# ---------------------------------------------------------------------------

def rwkv_tmix(p, x, *, tap: Tap, cfg: RwkvCfg, state=None,
              group: str = "rwkv") -> torch.Tensor:
    """The time mix of x (B,S,d). With a ``state`` (``init_rwkv_state``)
    the token shift and the recurrence start from it, and its
    ``tm_shift`` and ``wkv`` are overwritten in place with x's last row and
    the final matrix."""
    b, s, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    dx = _token_shift(x, None if state is None else state["tm_shift"]) - x

    # ddlerp: base mix, then per-stream LoRA refinement
    xbase = x + dx * p["mu"][_STREAMS]
    la = linear(p["mix_a"], xbase, tap=tap, group=group)
    la = torch.tanh(la).reshape(b, s, _STREAMS, cfg.mix_lora)
    mixed = []
    for i in range(_STREAMS):  # per-stream LoRA-B on a strided view, tapped
        lb_i = tap.dense(la[:, :, i], p["mix_b"][i], group=group)
        mixed.append(x + dx * (p["mu"][i] + lb_i))
    xr, xk, xv, xg, xw = mixed

    r = linear(p["wr"], xr, tap=tap, group=group)
    k = linear(p["wk"], xk, tap=tap, group=group)
    v = linear(p["wv"], xv, tap=tap, group=group)
    g = linear(p["wg"], xg, tap=tap, group=group)

    dw = linear(p["decay_a"], xw, tap=tap, group=group)
    dw = linear(p["decay_b"], torch.tanh(dw), tap=tap, group=group)
    w = torch.exp(-torch.exp(p["w0"] + dw.to(torch.float32)))    # (B,S,d)

    def heads(a):
        return a.reshape(b, s, nh, hd).to(torch.float32)
    ins = (heads(r), heads(k), heads(v), heads(w), p["u"].reshape(nh, hd))
    if state is None:
        o = wkv(*ins)
    else:
        o, s_final = wkv_from(*ins, state["wkv"])
        state["tm_shift"].copy_(x[:, -1])
        state["wkv"].copy_(s_final)
    o = o.reshape(b, s, d).to(x.dtype)

    o = layernorm(p["ln_x"], o, tap=tap)  # group-norm surrogate
    o = o * F.silu(g)
    return linear(p["wo"], o, tap=tap, group=group)


def rwkv_cmix(p, x, *, tap: Tap, cfg: RwkvCfg, state=None,
              group: str = "rwkv") -> torch.Tensor:
    """The channel mix of x (B,S,d). With a ``state`` the token shift
    starts from its ``cm_shift``, which is then overwritten in place with
    x's last row."""
    dx = _token_shift(x, None if state is None else state["cm_shift"]) - x
    if state is not None:
        state["cm_shift"].copy_(x[:, -1])
    xk = x + dx * p["mu"][0]
    xr = x + dx * p["mu"][1]
    k = linear(p["wk"], xk, tap=tap, group=group)
    k = torch.square(F.relu(k))
    kv = linear(p["wv"], k, tap=tap, group=group)
    r = linear(p["wr"], xr, tap=tap, group=group)
    return torch.sigmoid(r) * kv
