"""Batched serving engine: continuous-batching-lite request loop.

Port of ``src/repro/serve/engine.py``. Requests (prompt token lists) are
left-padded into a fixed batch of slots (with no pad mask, as in the
reference); prefill fills the caches, then greedy or temperature decode
runs step-locked for the whole batch, each slot keeping tokens until its
``max_new``. Finished batches are refilled from the queue (slot recycling
at batch granularity, the reference's continuous-batching core idea).

The caches (a family's ``init_caches``) are written in place by
``forward_tokens``; each batch gets fresh ones. Temperature sampling draws
from an explicit ``torch.Generator`` seeded with ``seed``; each decode step
reads its sampled tokens back to the host once, for all slots.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.nn.param import resolve_device


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class Engine:
    def __init__(self, arch_id: str, cfg, params, *, batch_slots: int = 4,
                 temperature: float = 0.0, seed: int = 0, device=None):
        """``cfg`` with its cache lengths set (``registry.serving_config``)
        and ``params`` on ``device`` (default CUDA)."""
        self.aspec = registry.get(arch_id)
        self.cfg = cfg
        self.mod = registry.family_module(self.aspec)
        self.params = params
        self.fwd = registry.make_forward_tokens(self.aspec, cfg)
        self.slots = batch_slots
        self.temperature = temperature
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits) -> torch.Tensor:
        """(B,) tokens from the last position's logits over the real vocab:
        the argmax, or a draw from softmax(logits / temperature)."""
        logits = logits[:, -1, : self.cfg.vocab]
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def generate(self, requests: List[Request]) -> List[Request]:
        """Process all requests; returns them with .out filled."""
        queue = list(requests)
        b = self.slots
        max_len = self.cfg.max_cache_len
        while queue:
            active, queue = queue[:b], queue[b:]
            n = len(active)
            plen = max(len(r.prompt) for r in active)
            ids = np.zeros((b, plen), np.int64)
            for i, r in enumerate(active):
                ids[i, plen - len(r.prompt):] = r.prompt  # left-pad
            caches = self.mod.init_caches(b, self.cfg, device=self.device)
            logits, caches = self.fwd(
                self.params, {"ids": torch.as_tensor(ids, device=self.device)},
                caches, 0)
            tok = self._sample(logits)
            outs = [[t] for t in tok.tolist()[:n]]
            steps = max(r.max_new for r in active)
            for t in range(1, min(steps, max_len - plen)):
                logits, caches = self.fwd(self.params, {"ids": tok[:, None]},
                                          caches, plen + t - 1)
                tok = self._sample(logits)
                toks = tok.tolist()
                for i in range(n):
                    if len(outs[i]) < active[i].max_new:
                        outs[i].append(toks[i])
            for i, r in enumerate(active):
                r.out = outs[i][: r.max_new]
        return requests
