"""Roofline terms per (arch × shape × mesh).

Port of ``src/repro/roofline/analysis.py``, on the H100 profile
(``roofline.constants``):

    compute term    = flops / (chips × peak FLOP/s)
    memory term     = bytes / (chips × HBM B/s)
    collective term = collective bytes / (chips × NVLink B/s)

The flops, bytes and collective bytes come from a record of the step on
``meta`` tensors (``roofline.hlo``): a full-depth record counts every
layer, so it is exact; ``launch.probes`` also extrapolates them from 1–3
layer records (``probe_metrics`` of each), the reference's fast path.

MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·tokens (serve); the ratio
MODEL_FLOPS / flops exposes the norms passes', the stats' and the MoE
dispatch's work over the model's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.common import ShapeSpec
from repro_torch.roofline import constants as C
from repro_torch.roofline import hlo


#: ``probe_metrics``' collective keys and the kinds they sum (the
#: reference's; the port records no collective-permute, so ``coll_cp`` is 0)
COLL_KEYS = {"coll_ar": hlo.ALL_REDUCE, "coll_ag": "all-gather",
             "coll_rs": "reduce-scatter", "coll_a2a": "all-to-all",
             "coll_cp": "collective-permute"}


def probe_metrics(trace) -> Dict[str, float]:
    """The linearly-extrapolatable metrics of one recorded probe: its
    flops, bytes and collective bytes, in all and by kind."""
    flops, nbytes = hlo.compiled_cost(trace)
    coll = hlo.collective_bytes(trace)
    return {"flops": flops, "bytes": nbytes,
            "coll_bytes": coll.get("total", 0.0),
            **{k: coll.get(kind, 0.0) for k, kind in COLL_KEYS.items()}}


def axis_metrics(trace) -> Dict[str, float]:
    """The collective bytes of one recorded probe by ``kind@axes``, the
    mesh axes of each collective's group (``roofline.hlo``)."""
    return {k: v for k, v in hlo.collective_bytes(trace).items()
            if "@" in k}


def n_active_for(arch_id: str, n_total: float, cfg) -> float:
    """Parameters a token's matmuls touch: without the embedding table (a
    gather, not a matmul — the MFU convention; the LM head stays), and
    with the routed experts counted at top_k / n_experts."""
    from repro_torch.dist.sharding import pad_to
    vocab_p = pad_to(cfg.vocab, 16)
    n = n_total - vocab_p * cfg.d_model
    moe = getattr(cfg, "moe", None)
    if moe is None:
        return n
    n_routed_layers = cfg.n_layers - getattr(cfg, "n_dense_prefix", 0)
    routed = n_routed_layers * moe.n_experts * 3 * cfg.d_model * moe.d_ff
    active_fraction = moe.top_k / moe.n_experts
    return n - routed * (1.0 - active_fraction)


def model_flops(shape: ShapeSpec, n_active: float) -> float:
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq * shape.batch
    tokens = shape.batch * (shape.seq if shape.kind == "prefill" else 1)
    return 2.0 * n_active * tokens


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    t_compute: float
    t_memory: float
    t_collective: float
    flops: float
    bytes: float
    coll_bytes: float
    model_flops: float
    useful_ratio: float       # MODEL_FLOPS / flops
    peak_gb_per_dev: float
    chips: int = 1
    profile: str = C.DEFAULT_PROFILE
    bottleneck: str = ""
    roofline_fraction: float = 0.0   # max-term share of total (≤1)

    def finish(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        tot = sum(terms.values())
        self.roofline_fraction = terms[self.bottleneck] / tot if tot else 0.0
        return self


def build_roofline(arch: str, shape_name: str, mesh_name: str,
                   metrics: Dict[str, float], model_fl: float,
                   peak_bytes: float, chips: int = 1,
                   profile: str = C.DEFAULT_PROFILE) -> Roofline:
    """The roofline of a cell from its whole-step ``metrics`` (all
    ``chips`` cards' flops, bytes and collective bytes)."""
    hw = C.get_profile(profile)
    fl = metrics["flops"]
    by = metrics["bytes"]
    cb = metrics["coll_bytes"]
    r = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        t_compute=fl / (chips * hw.peak_flops_bf16),
        t_memory=by / (chips * hw.hbm_bw),
        t_collective=cb / (chips * hw.link_bw),
        flops=fl, bytes=by, coll_bytes=cb, model_flops=model_fl,
        useful_ratio=model_fl / fl if fl else 0.0,
        peak_gb_per_dev=peak_bytes / 1e9, chips=chips, profile=hw.name)
    return r.finish()


def mfu(r: Roofline) -> float:
    """Model-FLOPs utilization implied by the roofline terms: useful
    flops / (chips × peak × max-term time)."""
    t = max(r.t_compute, r.t_memory, r.t_collective)
    if t <= 0:
        return 0.0
    return r.model_flops / (r.chips * C.get_profile(r.profile)
                            .peak_flops_bf16 * t)
