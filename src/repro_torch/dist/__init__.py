"""Distribution substrate: rules-based sharding and the data-parallel
per-example-norm pipeline on ``torch.distributed``.

Port of ``src/repro/dist/__init__.py``. ``repro_torch.dist.sharding`` is
the logical-axis layer and builds the meshes; ``repro_torch.dist.pex``
runs the ``core.plan`` passes data-parallel over a mesh, one process per
rank. See DESIGN.md §4.

``pex`` loads lazily, as in the reference: ``nn/`` imports
``dist.sharding`` (``pad_to``), and a model import need not load the plan
layer and ``torch.distributed``'s collectives with it. (The reference
breaks an import cycle this way; the port's imports have none, since its
taps do not call ``sharding.shard``.)
"""
from repro_torch.dist import sharding

__all__ = ["sharding", "pex"]


def __getattr__(name):
    if name == "pex":
        import importlib
        return importlib.import_module("repro_torch.dist.pex")
    raise AttributeError(f"module 'repro_torch.dist' has no attribute "
                         f"{name!r}")
