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
        return pm.pad_to(self.vocab, self.vocab_multiple)


def init_embedding(gen: torch.Generator, cfg: VocabCfg, *, dtype, device):
    table = pm.normal(gen, (cfg.vocab_p, cfg.d_model), dtype, device,
                      std=0.02)
    table[cfg.vocab:] = 0
    return {"table": table}


def embed(p, ids, *, tap: Tap, cfg: VocabCfg,
          group: str = "embed") -> torch.Tensor:
    x = tap.embedding(p["table"], ids, group=group)
    if cfg.scale_by_sqrt_dim:
        # the constant rounds to x's dtype first (bf16: √3584 → 59.75)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def init_lm_head(gen: torch.Generator, cfg: VocabCfg, *, dtype, device):
    return {"w": pm.normal(gen, (cfg.d_model, cfg.vocab_p), dtype, device,
                           std=0.02)}


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
    return logits


def per_example_xent(logits: torch.Tensor, labels: torch.Tensor,
                     label_mask: Optional[torch.Tensor] = None,
                     tap: Optional[Tap] = None) -> torch.Tensor:
    """Σ_t CE per example (paper §2: L^(j) over example j's targets). With
    a ``tap``, the (B, S) per-token loss map is registered first."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if label_mask is not None:
        ll = ll * label_mask
    token_losses = -ll
    if tap is not None:
        token_losses = tap.token_loss(token_losses)
    return torch.sum(token_losses, dim=tuple(range(1, token_losses.ndim)))
