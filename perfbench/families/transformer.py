"""The port's decoder-only transformer family (``repro_torch.models.
transformer``): a configuration file to the port's ``LMConfig``, and the
parameter tree that the benchmark fills from the seed.

The schema is written here from the published sizes and checked against
the tree the port's own ``init`` lays out (on ``meta``, shapes only): the
port decides where a tensor lives in its tree, the benchmark decides what
is in it. ``reading_routes`` reads the experts the port's MoE blocks
choose, which the reference then follows.
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.lib.weights import Init, paths


def _moe(c: dict) -> bool:
    return bool(c.get("num_local_experts"))


def program_config(c: dict):
    """The port's ``LMConfig`` of configuration file ``c``."""
    from repro_torch.models.transformer import LMConfig
    from repro_torch.nn.attention import AttnCfg
    from repro_torch.nn.mlp import MlpCfg
    from repro_torch.nn.moe import MoeCfg
    run = c["run"]
    d = c["hidden_size"]
    attn = AttnCfg(d_model=d, n_heads=c["num_attention_heads"],
                   n_kv=c["num_key_value_heads"], head_dim=c["head_dim"],
                   bias=c["qkv_bias"], rope_theta=c["rope_theta"],
                   head_multiple=run["head_multiple"], flash=run["flash"])
    kw = {}
    if _moe(c):
        kw["moe"] = MoeCfg(d_model=d, d_ff=c["intermediate_size"],
                           n_experts=c["num_local_experts"],
                           top_k=c["num_experts_per_tok"],
                           renorm_topk=run["renorm_topk"],
                           capacity_factor=run["capacity_factor"],
                           dispatch_groups=run["dispatch_groups"],
                           act=c["hidden_act"])
    else:
        kw["mlp"] = MlpCfg(d_model=d, d_ff=c["intermediate_size"],
                           act=c["hidden_act"])
    cfg = LMConfig(name=c["name"], n_layers=c["num_hidden_layers"],
                   d_model=d, vocab=c["vocab_size"], attn=attn,
                   rms_eps=c["rms_norm_eps"], dtype=run["dtype"],
                   remat=run["remat"], remat_policy=run["remat_policy"],
                   **kw)
    if cfg.attn.n_heads_p != cfg.attn.n_heads:
        raise ValueError(f"{c['name']}: head_multiple "
                         f"{run['head_multiple']} pads "
                         f"{cfg.attn.n_heads} query heads to "
                         f"{cfg.attn.n_heads_p}; the cell runs them as "
                         f"published")
    if cfg.vocab_cfg.vocab_p != cfg.vocab:
        raise ValueError(f"{c['name']}: the vocabulary would be padded")
    return cfg


def dtype_of(c: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[c["run"]["dtype"]]


def norm_dtype(c: dict) -> torch.dtype:
    """The RMSNorm gains' dtype: ``run.norm_dtype`` where the file sets
    it, else the model's."""
    name = c["run"].get("norm_dtype")
    return dtype_of(c) if name is None else \
        {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def schema(c: dict) -> dict:
    """The parameter tree of configuration ``c`` as ``Init`` leaves, with
    the port's initializer's distributions."""
    dt = dtype_of(c)
    gain = norm_dtype(c)
    d, v = c["hidden_size"], c["vocab_size"]
    hq = c["num_attention_heads"] * c["head_dim"]
    hkv = c["num_key_value_heads"] * c["head_dim"]
    f = c["intermediate_size"]

    def lin(d_in, d_out, bias=False, std=None):
        p = {"w": Init((d_in, d_out), dt, "normal",
                       std if std is not None else d_in ** -0.5)}
        if bias:
            p["b"] = Init((d_out,), dt, "zeros")
        return p

    def block():
        b = {"ln_attn": {"g": Init((d,), gain, "ones")},
             "ln_mlp": {"g": Init((d,), gain, "ones")},
             "attn": {"wq": lin(d, hq, c["qkv_bias"]),
                      "wk": lin(d, hkv, c["qkv_bias"]),
                      "wv": lin(d, hkv, c["qkv_bias"]),
                      "wo": lin(hq, d)}}
        if _moe(c):
            e = c["num_local_experts"]
            b["moe"] = {
                "router": {"w": Init((d, e), torch.float32, "normal", 0.02)},
                "gate": Init((e, d, f), dt, "normal", d ** -0.5),
                "up": Init((e, d, f), dt, "normal", d ** -0.5),
                "down": Init((e, f, d), dt, "normal", f ** -0.5)}
        else:
            b["mlp"] = {"gate": lin(d, f), "up": lin(d, f),
                        "down": lin(f, d)}
        return b

    return {"embed": {"table": Init((v, d), dt, "normal", 0.02)},
            "head": {"w": Init((d, v), dt, "normal", 0.02)},
            "ln_f": {"g": Init((d,), gain, "ones")},
            "blocks": [block() for _ in range(c["num_hidden_layers"])]}


def check_layout(c: dict, cfg) -> None:
    """Raise unless the port's ``init`` lays out exactly the schema's
    paths, shapes and dtypes (the gains in ``norm_dtype``)."""
    from repro_torch.models import transformer
    ours = {p: (tuple(i.shape), i.dtype) for p, i in paths(schema(c))}
    theirs = {p: (tuple(t.shape),
                  norm_dtype(c) if p[-1] == "g" else t.dtype)
              for p, t in paths(transformer.init(cfg, torch.Generator(),
                                                 device="meta"))}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()), key=str)
        raise ValueError(f"{c['name']}: the port's parameter tree differs "
                         f"from the benchmark's schema: {diff[:6]}")


def loss_fn(c: dict, cfg):
    """The port's tap-collector loss of this family (what
    ``registry.make_loss_fn_v2`` gives for it)."""
    from repro_torch.models import transformer

    def loss(params, batch, tap):
        return transformer.loss_fn(params, batch, tap, cfg=cfg)
    return loss


@contextlib.contextmanager
def reading_routes(cfg, batch: int, sink: list):
    """While open, append each expert choice the port's MoE routing makes
    (``nn.moe._route``), as a (batch, S, k) tensor, to ``sink``; yields the
    number of routed blocks a forward runs (a recompute repeats their
    choices after them), 0 for a dense model."""
    if cfg.moe is None:
        yield 0
        return
    from repro_torch.nn import moe
    route = moe._route

    def routing(mcfg, logits):
        gates, idx = route(mcfg, logits)
        sink.append(idx.reshape(batch, -1, idx.shape[-1]).clone())
        return gates, idx
    moe._route = routing
    try:
        yield cfg.n_layers
    finally:
        moe._route = route
