"""Training tokens from the seed: a frozen copy of the port's
``data/pipeline.SyntheticLM`` draw (numpy ``default_rng``), so that the
yardstick does not move when the program's pipeline does.

Every batch is a pure function of (seed, step): motif sequences (a shared
table of ``n_motifs`` motifs of ``motif_len`` tokens) with each token
replaced by a uniform draw over the whole vocabulary with a probability
drawn per example from U(0, 0.9), so examples differ in how learnable they
are and their gradient norms differ. Labels are the ids shifted by one.
Every seed gives the same shapes: only the tokens change.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticTokens:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int, *,
                 n_motifs: int = 64, motif_len: int = 8, device="cuda"):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = int(seed)
        self.motif_len = motif_len
        self.device = device
        base = np.random.default_rng(self.seed)
        self.motifs = base.integers(0, vocab, size=(n_motifs, motif_len))

    def arrays(self, step: int):
        """(ids, labels), int64 numpy arrays of shape (batch, seq)."""
        rng = np.random.default_rng((self.seed, step, 0, 0xDA7A))
        b, s = self.batch, self.seq
        noise_p = rng.uniform(0.0, 0.9, size=(b, 1))
        n_slots = s // self.motif_len + 1
        motif_ids = rng.integers(0, len(self.motifs), size=(b, n_slots))
        seqs = self.motifs[motif_ids].reshape(b, -1)[:, :s]
        noise = rng.integers(0, self.vocab, size=(b, s))
        take_noise = rng.uniform(size=(b, s)) < noise_p
        ids = np.where(take_noise, noise, seqs)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = ids[:, 0]
        return ids, labels

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        ids, labels = self.arrays(step)
        return {"ids": torch.as_tensor(ids, dtype=torch.long,
                                       device=self.device),
                "labels": torch.as_tensor(labels, dtype=torch.long,
                                          device=self.device)}
