"""Mesh construction for launchers and tests.

Port of ``src/repro/launch/mesh.py``. Functions, not module-level
constants: importing this module touches no process group. Each builds a
``DeviceMesh`` over the world that ``torch.distributed`` was initialized
with (one process per rank), on ``device_type`` ``"cuda"`` unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 over ("data", "model") (one 256-chip pod) or 2×16×16 over
    ("pod", "data", "model") (two pods): the reference's production shapes.
    Raises unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{shape} over {axes} needs a world of {need} ranks; this one "
            f"has {world}")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """A (world // model_parallel, model_parallel) mesh over ("data",
    "model") across every rank of the world (tests, examples, the train
    launcher's ``--data-parallel``)."""
    n = dist.get_world_size()
    if model_parallel <= 0 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {n} ranks")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), device_type=device_type)
