"""Shared by ``tests/test_torch_serve_lm.py`` and
``tests/test_torch_serve_families.py``: an arch's smoke serving setup in
both packages (the reference's ``init`` carried into the port by
``interop``, both packages' batches from numpy seed 3, the reference's
``forward_tokens`` jitted once), and the three checks each arch takes.

- ``decode_matches_reference``: the port's prefill of P tokens and every
  teacher-forced decode step after it against the reference's
  ``forward_tokens`` on the same tokens, the logits over the real vocab at
  ``STEP_RTOL`` of their largest |value| (f32; layers of reductions in
  another order, as the training parity's 1e-4).
- ``decode_from_reference_cache``: the reference's prefill caches carried
  into the port by ``interop``, one port decode step from them against the
  reference's step: the logits, and the caches the step leaves.
- ``decode_matches_own_full_forward``: the property of
  ``tests/test_serve.py``, on the port alone: prefill S-1 tokens, decode 1,
  and the last logits against the port's own full forward at 2e-3. MoE
  configs take ``capacity_factor = n_experts`` there, as the reference's
  test does: prefill + decode equals the full forward only without drops.

Each check makes fresh caches: ``forward_tokens`` writes them in place.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro_torch import interop
from repro_torch.configs.common import ShapeSpec
from repro_torch.models import registry

STEP_RTOL = 1e-4
OWN_TOL = 2e-3
B, S, P = 2, 8, 5


def drop_free(cfg):
    """``cfg`` with every expert's capacity enough for every token (a MoE
    config), else ``cfg``."""
    if getattr(cfg, "moe", None) is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def setup(arch, edit=lambda cfg: cfg):
    jspec, spec = jreg.get(arch), registry.get(arch)
    jcfg = edit(jreg.serving_config(jspec, jspec.smoke(),
                                    JShape("t", "decode", S, B)))
    cfg = edit(registry.serving_config(spec, spec.smoke(),
                                       ShapeSpec("t", "decode", S, B)))
    jmod, mod = jreg.family_module(jspec), registry.family_module(spec)
    jparams = unbox(jmod.init(jax.random.PRNGKey(0), jcfg))
    jbatch = jreg.make_train_batch(jspec, jcfg, JShape("t", "train", S, B),
                                   3)
    batch = registry.make_train_batch(spec, cfg, ShapeSpec("t", "train", S,
                                                           B), 3,
                                      device="cpu")
    return dict(
        arch=arch, family=spec.family, cfg=cfg, jcfg=jcfg, jmod=jmod,
        mod=mod, jparams=jparams, jbatch=jbatch, batch=batch,
        params=interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        jfwd=jax.jit(jreg.make_forward_tokens(jspec, jcfg)),
        fwd=registry.make_forward_tokens(spec, cfg))


def prefix(batch, n):
    """The first n tokens of a batch: ids, visual embeds and mask, the
    (B, 3, S) positions; seamless's source frames whole (the encoder sees
    the full source)."""
    out = {}
    for k, v in batch.items():
        if k == "positions":
            out[k] = v[:, :, :n]
        elif k == "src_frames":
            out[k] = v
        elif k != "labels":
            out[k] = v[:, :n]
    return out


def close(got, want, rtol=STEP_RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _real(logits, cfg):
    return logits[..., :cfg.vocab]


def decode_matches_reference(st, rtol=STEP_RTOL):
    cfg, jcfg = st["cfg"], st["jcfg"]
    jc = st["jmod"].init_caches(B, jcfg)
    c = st["mod"].init_caches(B, cfg, device="cpu")
    jl, jc = st["jfwd"](st["jparams"], prefix(st["jbatch"], P), jc, 0)
    tl, c = st["fwd"](st["params"], prefix(st["batch"], P), c, 0)
    close(_real(tl, cfg), _real(jl, cfg), rtol)
    for t in range(P, S):
        jl, jc = st["jfwd"](st["jparams"],
                            {"ids": st["jbatch"]["ids"][:, t:t + 1]}, jc, t)
        tl, c = st["fwd"](st["params"],
                          {"ids": st["batch"]["ids"][:, t:t + 1]}, c, t)
        close(_real(tl, cfg), _real(jl, cfg), rtol)


def decode_from_reference_cache(st, rtol=STEP_RTOL):
    cfg, fam = st["cfg"], st["family"]
    _, jc = st["jfwd"](st["jparams"], prefix(st["jbatch"], P),
                       st["jmod"].init_caches(B, st["jcfg"]), 0)
    c = interop.caches_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                                  fam, device="cpu")
    step = {"ids": st["jbatch"]["ids"][:, P:P + 1]}
    jl, jc = st["jfwd"](st["jparams"], step, jc, P)
    tl, c = st["fwd"](st["params"], {"ids": st["batch"]["ids"][:, P:P + 1]},
                      c, P)
    close(_real(tl, cfg), _real(jl, cfg), rtol)
    got = dict(jax.tree_util.tree_leaves_with_path(
        interop.caches_to_numpy(c, fam)))
    for path, want in jax.tree_util.tree_leaves_with_path(jc):
        close(torch.from_numpy(got[path]), want, rtol)


def full_forward(st, params, cfg, batch):
    """The port's full forward: ``forward_tokens`` without caches for the
    transformer family (as the reference's test calls it), from fresh
    caches at 0 for the others."""
    mod = st["mod"]
    fwd = registry.make_forward_tokens(registry.get(st["arch"]), cfg)
    if st["family"] == "transformer":
        return fwd(params, batch, None, None)[0]
    return fwd(params, batch, mod.init_caches(B, cfg, device="cpu"), 0)[0]


def decode_matches_own_full_forward(st):
    cfg = drop_free(st["cfg"])
    params, batch, mod = st["params"], st["batch"], st["mod"]
    fwd = registry.make_forward_tokens(registry.get(st["arch"]), cfg)
    want = full_forward(st, params, cfg, batch)
    c = mod.init_caches(B, cfg, device="cpu")
    _, c = fwd(params, prefix(batch, S - 1), c, 0)
    got, _ = fwd(params, {"ids": batch["ids"][:, S - 1:]}, c, S - 1)
    close(_real(got[:, 0], cfg), _real(want[:, -1], cfg).numpy(), OWN_TOL)
