"""Batched serving: prefill and step-locked decode over the families'
caches. Port of ``src/repro/serve``."""
from repro_torch.serve.engine import Engine, Request

__all__ = ["Engine", "Request"]
