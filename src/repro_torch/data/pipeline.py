"""Deterministic, resumable synthetic-token data pipeline.

Port of ``src/repro/data/pipeline.py``. Every batch is a pure function of
(seed, step, host), drawn with numpy's ``default_rng`` exactly as the
reference draws it, so each batch equals the reference's bit for bit; only
the container differs: ``batch_at`` returns int64 tensors on the
pipeline's device (CUDA unless the caller names another). Sharding: each
data-parallel host materializes only its slice (host_id, num_hosts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.nn.param import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    # synthetic-LM structure: repeated motifs make the loss learnable,
    # with per-example difficulty variation (exercises importance sampling)
    n_motifs: int = 64
    motif_len: int = 8


@dataclasses.dataclass
class PipelineState:
    """Everything needed to resume the stream: the step cursor and the
    seed that generated it."""
    step: int = 0
    seed: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        missing = [k for k in ("step", "seed") if k not in d]
        if missing:
            raise ValueError(
                f"pipeline state is missing key(s) {missing} (have "
                f"{sorted(d)}); refusing to resume onto an unknown "
                f"data cursor")
        return cls(step=int(d["step"]), seed=int(d["seed"]))


class SyntheticLM:
    """Motif-mixture LM stream. Deterministic in (seed, step, host)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1,
                 device=None):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"divide over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.device = resolve_device(device)
        base = np.random.default_rng(cfg.seed)
        self.motifs = base.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id, 0xDA7A))
        b, s = self.local_batch, cfg.seq
        # per-example noise level → heterogeneous gradient norms
        noise_p = rng.uniform(0.0, 0.9, size=(b, 1))
        n_slots = s // cfg.motif_len + 1
        motif_ids = rng.integers(0, cfg.n_motifs, size=(b, n_slots))
        seqs = self.motifs[motif_ids].reshape(b, -1)[:, :s]
        noise = rng.integers(0, cfg.vocab, size=(b, s))
        take_noise = rng.uniform(size=(b, s)) < noise_p
        ids = np.where(take_noise, noise, seqs)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = ids[:, 0]
        return {"ids": torch.as_tensor(ids, dtype=torch.long,
                                       device=self.device),
                "labels": torch.as_tensor(labels, dtype=torch.long,
                                          device=self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


# --- elastic host renumbering ----------------------------------------------
#
# The global token stream must not depend on the topology: the shard grid
# is fixed at launch ("logical shards", one per host of the launch
# topology) and only the ownership of shards moves when hosts come and go.
# Each logical shard is a pure (seed, step, shard) stream, so the
# concatenation over shards never depends on which host owns which shard.

def assign_logical_shards(n_logical: int,
                          active_hosts: Sequence[int]) -> Dict[int, List[int]]:
    """Order-preserving, contiguous, balanced assignment of the fixed
    logical shard grid onto the (sorted) active host set: the k-th active
    host owns shards [k·m, (k+1)·m)."""
    hosts = sorted(active_hosts)
    if not hosts:
        raise ValueError("no active hosts to assign shards to")
    if n_logical % len(hosts):
        raise ValueError(
            f"{n_logical} logical shards do not divide over "
            f"{len(hosts)} hosts; contract/expand to a divisor "
            f"(power-of-two topologies guarantee this)")
    m = n_logical // len(hosts)
    return {h: list(range(k * m, (k + 1) * m))
            for k, h in enumerate(hosts)}


class LogicalShardedLM:
    """``SyntheticLM`` over a fixed logical shard grid: ``global_batch_at``
    is a pure function of (cfg.seed, step) alone."""

    def __init__(self, cfg: DataConfig, n_logical: int, device=None):
        if cfg.global_batch % n_logical:
            raise ValueError(f"global_batch {cfg.global_batch} not "
                             f"divisible into {n_logical} logical shards")
        self.cfg = cfg
        self.n_logical = n_logical
        self.shards = [SyntheticLM(cfg, host_id=i, num_hosts=n_logical,
                                   device=device)
                       for i in range(n_logical)]

    def shard_batch_at(self, step: int, shard_ids: Sequence[int]):
        """One physical host's slice: its owned logical shards, in shard
        order."""
        parts = [self.shards[i].batch_at(step) for i in shard_ids]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def global_batch_at(self, step: int,
                        owned: Optional[Dict[int, List[int]]] = None):
        """The full global batch; with ``owned`` (host → shard list),
        assembled host by host in sorted host order, which equals the
        logical-order concatenation iff the assignment preserves order."""
        if owned is None:
            return self.shard_batch_at(step, range(self.n_logical))
        return self.shard_batch_at(
            step, [i for h in sorted(owned) for i in owned[h]])

    def batch_at(self, step: int):
        """Trainer data-source protocol (the full global batch)."""
        return self.global_batch_at(step)
