"""Mamba2 (SSD) block for zamba2 — selective state-space with multi-head
state (headdim × d_state), scalar-per-head decay.

Port of ``src/repro/nn/ssm.py``:

    h_t = exp(Δ_t·A) h_{t-1} + Δ_t·B_t ⊗ x_t          (per head)
    y_t = C_t·h_t + D ⊙ x_t

``in_proj`` and ``out_proj`` are dense taps, ``dt_bias`` a bias tap (on
the f32 Δ) and the gated RMSNorm's gain ``norm_g`` a scale tap, as in the
reference; ``conv_w``, ``conv_b``, ``a_log`` and ``d`` are trained but
outside the pex scope (``models.registry.UNTAPPED_ALLOWLIST``).

The SSD recurrence holds no tap. It runs in f32, with the reference's
expressions in its order (``_ssd_step``), over chunks of ``CHUNK`` time
steps (``ssd``): the forward keeps only each chunk's first state, and the
backward recomputes a chunk's states from it and runs the reverse
recurrence by hand, so the saved state is S/CHUNK states and not S. The
forward gives the bits of the plain per-step loop (``ssd_loop``).

Decode is the same recurrence from a carried state: ``init_ssm_state``
holds each layer's f32 SSD state ``h`` and the causal conv's last K-1
input rows ``conv``; with a ``state``, ``ssm`` reads both and writes the
segment's final ones back into it in place (``ssd_from``: the per-step
body of ``ssd_loop`` from the given state).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Tap
from repro_torch.dist.sharding import on_rows, shard
from repro_torch.nn import param as pm
from repro_torch.nn.linear import init_linear, linear

#: time steps of each chunk of the SSD recurrence (the backward keeps one
#: state per chunk and recomputes the chunk's others)
CHUNK = 64


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def init_ssm(gen: torch.Generator, cfg: SsmCfg, *, dtype, device):
    di, ds, nh = cfg.d_inner, cfg.d_state, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    # in_proj → [z(di), x(di), B(ds), C(ds), dt(nh)]
    return {
        "in_proj": init_linear(gen, cfg.d_model, 2 * di + 2 * ds + nh,
                               axes=("embed", "mlp"), **kw),
        "conv_w": pm.normal(gen, (cfg.conv_width, cfg.conv_dim), dtype,
                            device, std=cfg.conv_width ** -0.5,
                            axes=(None, "mlp")),
        "conv_b": pm.zeros((cfg.conv_dim,), dtype, device, axes=("mlp",)),
        "a_log": pm.box(torch.log(torch.arange(1, nh + 1,
                                               dtype=torch.float32,
                                               device=device)), (None,)),
        "d": pm.ones((nh,), torch.float32, device, axes=(None,)),
        "dt_bias": pm.zeros((nh,), torch.float32, device, axes=(None,)),
        "norm_g": pm.ones((di,), dtype, device, axes=("mlp",)),
        "out_proj": init_linear(gen, di, cfg.d_model, axes=("mlp", "embed"),
                                **kw),
    }


def init_ssm_state(batch: int, cfg: SsmCfg, *, dtype, device):
    """One layer's decode state: the SSD state ``h`` (B, nh, hd, ds) in f32
    and the conv history ``conv`` (B, K-1, conv_dim) in ``dtype``, zero."""
    return {"h": torch.zeros(batch, cfg.n_heads, cfg.head_dim, cfg.d_state,
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, cfg.conv_dim,
                                dtype=dtype, device=device)}


def _causal_conv(x, w, b, state=None):
    """x (B,S,C) depthwise causal conv of width K = w.shape[0]: the
    reference's sum of shifted products, in x's dtype, over the history
    ``state`` (B, K-1, C) of the previous segment (cast to x's dtype) or a
    zero one (training). Returns (out, the new (B, K-1, C) history)."""
    kw, s = w.shape[0], x.shape[1]
    pad = x.new_zeros(x.shape[0], kw - 1, x.shape[2]) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(kw)) + b
    return out, xp[:, xp.shape[1] - (kw - 1):]


# ---------------------------------------------------------------------------
# the SSD recurrence
# ---------------------------------------------------------------------------

def _ssd_step(h, x_t, b_t, c_t, dt_t, dec_t):
    """One step of the reference's scan body: x_t (B,nh,hd), b_t, c_t
    (B,ds), dt_t, dec_t (B,nh), state h (B,nh,hd,ds) → (h, y_t (B,nh,hd))."""
    dbx = torch.einsum("bhd,bn,bh->bhdn", x_t, b_t, dt_t)
    h = h * dec_t[:, :, None, None] + dbx
    return h, torch.einsum("bhdn,bn->bhd", h, c_t)


def ssd_from(x, bm, cm, dt, dec, h):
    """The plain per-step loop from ``h`` (B,nh,hd,ds) f32: x (B,S,nh,hd),
    bm, cm (B,S,ds), dt, dec (B,S,nh), all f32 → (y (B,S,nh,hd), the final
    state)."""
    ys = []
    for t in range(x.shape[1]):
        h, y_t = _ssd_step(h, x[:, t], bm[:, t], cm[:, t], dt[:, t],
                           dec[:, t])
        ys.append(y_t)
    return torch.stack(ys, dim=1), h


def ssd_loop(x, bm, cm, dt, dec):
    """The plain per-step loop from a zero state: x (B,S,nh,hd), bm, cm
    (B,S,ds), dt, dec (B,S,nh), all f32 → y (B,S,nh,hd). Autograd keeps
    every step's state."""
    b, _, nh, hd = x.shape
    return ssd_from(x, bm, cm, dt, dec, x.new_zeros(b, nh, hd,
                                                    bm.shape[-1]))[0]


class _Ssd(torch.autograd.Function):
    """``ssd_loop`` over chunks of ``chunk`` steps, keeping each chunk's
    first state (the second output, not differentiable) for the backward,
    which recomputes the chunk's states from it and runs the reverse
    recurrence by hand. Pure tensor ops with ``setup_context``, so
    ``torch.func`` transforms run it through the generated vmap rule."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, bm, cm, dt, dec, chunk):
        b, s, nh, hd = x.shape
        h = x.new_zeros(b, nh, hd, bm.shape[-1])
        ys, starts = [], []
        for t in range(s):
            if t % chunk == 0:
                starts.append(h)
            h, y_t = _ssd_step(h, x[:, t], bm[:, t], cm[:, t], dt[:, t],
                               dec[:, t])
            ys.append(y_t)
        return torch.stack(ys, dim=1), torch.stack(starts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, bm, cm, dt, dec, chunk = inputs
        ctx.save_for_backward(x, bm, cm, dt, dec, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, _):
        x, bm, cm, dt, dec, starts = ctx.saved_tensors
        chunk = ctx.chunk
        s = x.shape[1]
        dh = torch.zeros_like(starts[0])     # ∂L/∂h_t from the steps after t
        grads = [[None] * s for _ in range(5)]
        for c in reversed(range(starts.shape[0])):
            t0, t1 = c * chunk, min(s, (c + 1) * chunk)
            hs = [starts[c]]                 # h_{t0-1}, ..., h_{t1-1}
            for t in range(t0, t1):
                hs.append(_ssd_step(hs[-1], x[:, t], bm[:, t], cm[:, t],
                                    dt[:, t], dec[:, t])[0])
            for t in reversed(range(t0, t1)):
                x_t, b_t, c_t, dt_t, dec_t, dy_t = (
                    x[:, t], bm[:, t], cm[:, t], dt[:, t], dec[:, t],
                    dy[:, t])
                h_t, h_p = hs[t - t0 + 1], hs[t - t0]
                dh = dh + dy_t[..., None] * c_t[:, None, None, :]
                # ∂L/∂(Δ·B ⊗ x) = dh, contracted two operands at a time
                dhb = torch.einsum("bhdn,bn->bhd", dh, b_t)
                grads[0][t] = dhb * dt_t[..., None]
                grads[1][t] = torch.einsum("bhdn,bhd->bn", dh,
                                           x_t * dt_t[..., None])
                grads[2][t] = torch.einsum("bhd,bhdn->bn", dy_t, h_t)
                grads[3][t] = torch.sum(dhb * x_t, dim=-1)
                grads[4][t] = torch.sum(dh * h_p, dim=(2, 3))
                dh = dh * dec_t[:, :, None, None]
        return tuple(torch.stack(g, dim=1) for g in grads) + (None,)


def ssd(x, bm, cm, dt, dec):
    """The SSD recurrence from a zero state over chunks of ``CHUNK`` steps
    (see ``_Ssd``): the bits of :func:`ssd_loop`, with S/CHUNK saved
    states instead of S. DTensor operands run on each rank's rows
    (``dist.sharding.on_rows``): the recurrence is per example."""
    return on_rows(lambda *a: _Ssd.apply(*a, CHUNK)[0],
                   (x, bm, cm, dt, dec))


def ssm(p, x, *, tap: Tap, cfg: SsmCfg, state=None,
        group: str = "ssm") -> torch.Tensor:
    """x (B,S,d_model) → y (B,S,d_model). With a ``state``
    (``init_ssm_state``) the conv and the recurrence start from it, and its
    ``conv`` and ``h`` are overwritten in place with the segment's final
    ones."""
    b, s, _ = x.shape
    di, ds, nh, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    f32 = torch.float32

    zxbcdt = linear(p["in_proj"], x, tap=tap, group=group)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = zxbcdt[..., -nh:]

    xbc, tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                             None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    bs = xbc[..., di:di + ds]
    cs = xbc[..., di + ds:]

    dt = tap.bias_add(dt.to(f32), p["dt_bias"], group=group)
    dt = F.softplus(dt)                                           # (B,S,nh)
    a = -torch.exp(p["a_log"])                                    # (nh,)
    decay = torch.exp(dt * a)                                     # (B,S,nh)

    ins = (xs.to(f32), bs.to(f32), cs.to(f32), dt, decay)
    if state is None:
        y = ssd(*ins)                                             # (B,S,nh,hd)
    else:
        y, h = ssd_from(*ins, state["h"])
        state["h"].copy_(h)
        state["conv"].copy_(tail)

    # skip connection D ⊙ x
    y = y + xs.to(f32) * p["d"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)

    # gated RMSNorm (mamba2's norm before out_proj)
    yf = y.to(f32) * F.silu(z.to(f32))
    yf = yf * torch.rsqrt(torch.mean(torch.square(yf), dim=-1, keepdim=True)
                          + 1e-6)
    y = tap.scale(yf.to(x.dtype), p["norm_g"], group=group)
    return shard(linear(p["out_proj"], y, tap=tap, group=group),
                 "batch", None, "embed_act")
