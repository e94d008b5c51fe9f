"""Distribution substrate: rules-based sharding and the data-parallel
per-example-norm pipeline on ``torch.distributed``.

Port of ``src/repro/dist/__init__.py``. ``repro_torch.dist.sharding`` is
the logical-axis layer, builds the meshes and lays DTensor parameters out
by their logical axes (the model-axis route: ``Engine`` with ``mesh=None``
under ``use_rules(mesh, rules)``); ``repro_torch.dist.pex`` runs the
``core.plan`` passes data-parallel over a mesh, one process per rank. See
DESIGN.md §4.

``pex`` loads lazily, as in the reference: ``nn/`` and ``core/taps``
import ``dist.sharding`` (``pad_to``, ``shard``), and ``dist.pex`` imports
the plan layer, which imports the taps: a model import need not load the
plan layer and ``torch.distributed``'s collectives with it.
"""
from repro_torch.dist import sharding

__all__ = ["sharding", "pex"]


def __getattr__(name):
    if name == "pex":
        import importlib
        return importlib.import_module("repro_torch.dist.pex")
    raise AttributeError(f"module 'repro_torch.dist' has no attribute "
                         f"{name!r}")
