"""Sharded, async, atomic checkpointing with elastic restore.

Port of ``src/repro/ckpt``: :class:`~repro_torch.ckpt.checkpoint.CheckpointManager`
writes and reads the reference's on-disk layout.
"""
from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
