"""Token embedding + LM head, with vocab padding.

Port of ``src/repro/nn/embedding.py``. Padded vocab rows are zero-init and
their logits are masked to -inf, so losses, gradients and per-example stats
are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import taps
from repro_torch.core.taps import Tap
from repro_torch.dist.sharding import is_dtensor, pad_to, shard
from repro_torch.nn import param as pm

NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class VocabCfg:
    vocab: int
    d_model: int
    vocab_multiple: int = 16
    logit_softcap: Optional[float] = None   # gemma2 final softcap
    scale_by_sqrt_dim: bool = False         # gemma multiplies embeds by √d

    @property
    def vocab_p(self) -> int:
        return pad_to(self.vocab, self.vocab_multiple)


def init_embedding(gen: torch.Generator, cfg: VocabCfg, *, dtype, device):
    table = pm.normal(gen, (cfg.vocab_p, cfg.d_model), dtype, device,
                      std=0.02, axes=("vocab", "embed"))
    table[cfg.vocab:] = 0
    return {"table": table}


def embed(p, ids, *, tap: Tap, cfg: VocabCfg,
          group: str = "embed") -> torch.Tensor:
    x = tap.embedding(p["table"], ids, group=group)
    if cfg.scale_by_sqrt_dim:
        # the constant rounds to x's dtype first (bf16: √3584 → 59.75)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return shard(x, "batch", None, "embed_act")


def init_lm_head(gen: torch.Generator, cfg: VocabCfg, *, dtype, device):
    return {"w": pm.normal(gen, (cfg.d_model, cfg.vocab_p), dtype, device,
                           std=0.02, axes=("embed", "vocab"))}


def lm_head(p, x, *, tap: Tap, cfg: VocabCfg,
            group: str = "head") -> torch.Tensor:
    """Logits of x (B, S, d_model), softcapped (gemma2: ``cap ·
    tanh(logits / cap)`` in the logits' dtype) and the vocab padding
    masked to -inf. The head's stat takes the tap's method like any dense layer: under
    ``method="auto"`` the priced pick, which sends llama3.2-1b's head at
    S=512 to the gram kernel. The reference forces the direct route here
    for its TPU kernels; both routes give the same norm."""
    t = tap if tap.spec.tap_head else taps.NULL
    logits = t.dense(x, p["w"], group=group)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_p != cfg.vocab:
        mask = torch.arange(cfg.vocab_p, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    return shard(logits, "batch", None, "vocab_act")


def per_example_xent(logits: torch.Tensor, labels: torch.Tensor,
                     label_mask: Optional[torch.Tensor] = None,
                     tap: Optional[Tap] = None) -> torch.Tensor:
    """Σ_t CE per example (paper §2: L^(j) over example j's targets). With
    a ``tap``, the (B, S) per-token loss map is registered first.
    DTensor logits take :func:`_sharded_ll` (no logits gathered)."""
    if is_dtensor(logits):
        ll = _sharded_ll(logits, labels)
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if label_mask is not None:
        ll = ll * label_mask
    token_losses = -ll
    if tap is not None:
        token_losses = tap.token_loss(token_losses)
    return torch.sum(token_losses, dim=tuple(range(1, token_losses.ndim)))


def _sharded_ll(logits, labels):
    """The (B, S) label log-likelihoods of DTensor logits (B, S, V), in f32,
    without gathering them: each rank takes its rows and its vocabulary
    columns (the logits' ``Shard(0)`` and ``Shard(2)`` mesh dims), its
    local max (the stabilizer, taken over the vocabulary shards by one
    all-reduce of the max, no gradient through it), its local Σ exp and
    the label's logit where the label falls in its columns, and the two
    sums take one all-reduce each over the vocabulary shards:
    log p(label) = logit − max − log Σ exp(logit − max)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = logits.device_mesh
    pl, rows, vocab = [], [], []
    for p in logits.placements:
        r = isinstance(p, Shard) and p.dim % 3 == 0
        v = isinstance(p, Shard) and p.dim % 3 == 2
        rows.append(r), vocab.append(v)
        pl.append(Shard(0) if r else Shard(2) if v else Replicate())
    row_pl = [Shard(0) if r else Replicate() for r in rows]
    x = logits.redistribute(mesh, pl).to_local(grad_placements=pl)
    x = x.to(torch.float32)
    lab = labels if is_dtensor(labels) else DTensor.from_local(
        labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lab = lab.redistribute(mesh, row_pl).to_local().long()
    _, offset = compute_local_shape_and_global_offset(
        tuple(logits.shape), mesh, pl)
    v0, v_loc = offset[2], x.shape[-1]
    shape = tuple(logits.shape[:2])
    stride = (shape[1], 1)

    def whole(local, partial):
        return DTensor.from_local(
            local, mesh, [Shard(0) if r else partial if v else Replicate()
                          for r, v in zip(rows, vocab)],
            run_check=False, shape=shape, stride=stride
        ).redistribute(mesh, row_pl).to_local()
    m = whole(x.detach().amax(dim=-1), Partial("max"))
    se = whole(torch.sum(torch.exp(x - m[..., None]), dim=-1), Partial())
    inside = (lab >= v0) & (lab < v0 + v_loc)
    pick = torch.gather(x, -1, torch.where(inside, lab - v0, 0)[..., None])
    picked = whole(torch.where(inside, pick[..., 0], 0.0), Partial())
    ll = picked - m - torch.log(se)
    return DTensor.from_local(ll, mesh, row_pl, run_check=False,
                              shape=shape, stride=stride)
