"""Kernel-launch validator: prove every CUDA launch is well-formed without
making it (pexlint pass 3, DESIGN.md §10).

Port of ``src/repro/analysis/launch.py``, for the H100. The wrappers
(``kernels.ops``) pick the plan, tiles and grid of each launch; the kernels
take their shared memory and threads from constants of ``csrc/``. A bad
schedule fails on the card at launch (``cudaErrorInvalidValue``, too much
shared memory) or, worse, reads out of bounds; on the CPU, where the tests
run, nothing launches at all. This pass closes that gap statically: each
launch is described as a ``LaunchContract`` (``kernels.contract``) by the
contract functions beside the wrappers, from the launcher's own plan, and
``contract.validate`` checks it against the card's budgets.

Workloads come from three sources:

  * the **kernel sites of a trace** — every launch a recorded step makes on
    the card's route (``analysis._trace``), at its exact operand shapes,
    strides and dtypes;
  * the **Tap sites of a trace** (``coverage.TapSite``), each giving the
    launches its stat could dispatch to at its operand shapes (gram and
    direct for a sequence dense tap, ``rowsumsq`` and ``clip_scale`` for
    the token and one-pass routes, ``segmented_norm`` for an expert tap),
    whichever the priced pick takes;
  * **config-derived production cases** — full model widths at a training
    shape, the flash geometry included, which smoke traces never reach.

The reference validated against a TPU core's VMEM; the port's backend is
the card (``BACKENDS``), and asking for another is an error.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import contract as _c
from repro_torch.kernels import ops

#: the budget profiles a launch is validated against
BACKENDS = ("cuda",)


@dataclasses.dataclass(frozen=True)
class LaunchReport:
    contracts: Tuple[_c.LaunchContract, ...]
    errors: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        head = (f"{len(self.contracts)} kernel launches checked, "
                f"{len(self.errors)} ERROR")
        return "\n".join([head] + [f"  ERROR {e}" for e in self.errors])

    def raise_if_errors(self) -> "LaunchReport":
        if not self.ok:
            raise AssertionError("kernel launch validation failed:\n"
                                 + self.summary())
        return self


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"launch contracts are checked for the card "
                         f"(backend {BACKENDS[0]!r}); {backend!r} has no "
                         f"meaning in the port")


def _dt(name: str):
    return getattr(torch, name)


def contracts_for_site(site) -> list:
    """Launch contracts for one site: a trace's kernel site (``_trace.Op``
    of kind "kernel") gives the launch it records; a ``coverage.TapSite``
    the launches its stat could dispatch to at the traced operand
    shapes."""
    if getattr(site, "kind", None) == "kernel":
        m = dict(site.meta)
        return ops.contract_for_launch(site.name, **m)
    out = []
    avals = site.operand_avals
    if site.op == "dense":
        (h_shape, h_dt), (w_shape, _) = avals[0], avals[1]
        p_in, p_out = w_shape[-2], w_shape[-1]
        dt = _dt(h_dt)
        if len(h_shape) >= 3:
            b, s = h_shape[0], h_shape[1]
            out.append(ops.gram_contract(b, s, p_in, p_out, dtype=dt))
            out.append(ops.direct_contract(b, s, p_in, p_out, dtype=dt))
            out.append(ops.clip_scale_contract(b, s, p_out, dtype=dt))
            out.append(ops.rowsumsq_contract(b, s, p_in, dtype=dt))
            out.append(ops.rowsumsq_contract(b, s, p_out, dtype=dt))
    elif site.op in ("bias_add", "scale", "embedding"):
        z_shape, z_dt = avals[0]
        if len(z_shape) >= 3:
            n = 1
            for d in z_shape[2:]:
                n *= d
            out.append(ops.rowsumsq_contract(z_shape[0], z_shape[1], n,
                                             dtype=_dt(z_dt)))
    elif site.op in ("dense_expert", "dense_expert_grouped"):
        (x_shape, x_dt), (w_shape, _) = avals[0], avals[1]
        acc_shape, _ = avals[-1]
        x_shape = x_shape if site.op == "dense_expert_grouped" \
            else (1,) + tuple(x_shape)
        ng, e, c, d = x_shape
        f = w_shape[-1]
        bg = max(acc_shape[0] // max(ng, 1), 1)
        out.extend(ops.segmented_contract(ng * e * c, ng * e * bg, d, f,
                                          dtype=_dt(x_dt)))
    elif site.op == "dense_batched":
        (h_shape, h_dt), (w_shape, _) = avals[0], avals[1]
        if len(h_shape) >= 3:
            b, s = h_shape[0], h_shape[1]
            out.extend(ops.segmented_contract(b * s, b, w_shape[-2],
                                              w_shape[-1], dtype=_dt(h_dt)))
    return out


def contracts_for_sites(sites: Sequence) -> list:
    out = []
    for site in sites:
        out.extend(contracts_for_site(site))
    return out


def production_cases(cfg, *, batch: int = 8, seq: int = 4096) -> list:
    """Config-derived launch cases at production widths: the dense-stat
    kernels at (d_model, d_model), (d_model, d_ff), (d_ff, d_model) and
    (d_model, vocab), the token route's ``rowsumsq``, and the flash
    forward/backward geometry; the expert launch for a MoE config."""
    out = []
    dt = getattr(cfg, "torch_dtype", torch.float32)
    d_model = getattr(cfg, "d_model", None)
    mlp = getattr(cfg, "mlp", None)
    d_ff = getattr(cfg, "d_ff", None) or getattr(mlp, "d_ff", None)
    vocab = getattr(cfg, "vocab", None)
    if d_model:
        pairs = [(d_model, d_model)]
        if d_ff:
            pairs += [(d_model, d_ff), (d_ff, d_model)]
        if vocab:
            pairs.append((d_model, vocab))
        for p_in, p_out in pairs:
            out.append(ops.gram_contract(batch, seq, p_in, p_out, dtype=dt))
            out.append(ops.direct_contract(batch, seq, p_in, p_out,
                                           dtype=dt))
            out.append(ops.clip_scale_contract(batch, seq, p_out, dtype=dt))
        out.append(ops.rowsumsq_contract(batch, seq, d_model, dtype=dt))
    attn = getattr(cfg, "attn", None)
    if attn is not None and attn.head_dim in (32, 64, 128):
        out.extend(ops.attention_contracts(
            batch, attn.n_heads, attn.n_kv, seq, seq, attn.head_dim,
            dtype=dt, window=attn.window))
    moe = getattr(cfg, "moe", None)
    if moe is not None and d_model:
        cap = moe.capacity(batch * seq)
        out.extend(ops.segmented_contract(
            moe.n_experts * max(cap, 1), moe.n_experts * batch, d_model,
            moe.d_ff, dtype=dt))
    return out


def validate_contracts(contracts: Sequence, *,
                       backend: str = "cuda") -> LaunchReport:
    _check_backend(backend)
    errors = []
    for ct in contracts:
        errors.extend(_c.validate(ct))
    # identical workloads repeat across layers/sites — dedupe messages
    seen, uniq = set(), []
    for e in errors:
        if e not in seen:
            seen.add(e)
            uniq.append(e)
    return LaunchReport(tuple(contracts), tuple(uniq))


def validate_sites(sites: Sequence, cfg=None, *, backend: str = "cuda",
                   batch: int = 8, seq: int = 4096,
                   production: bool = True) -> LaunchReport:
    """Full pass: site workloads plus (optionally) the config-derived
    production cases."""
    _check_backend(backend)
    contracts = contracts_for_sites(sites)
    if production and cfg is not None:
        contracts.extend(production_cases(cfg, batch=batch, seq=seq))
    return validate_contracts(contracts, backend=backend)
