"""Clipping — the coefficient math behind the ``Clip`` consumer.

Port of what ``core/plan.py`` takes from ``src/repro/core/clipping.py`` for
example-granularity clipping: the per-example coefficients
``min(1, C/‖g_j‖)``, which the plan folds into the seed of one reweighted
backward (``core.passes.clip_coefficients``, re-exported here).

Not in this slice: ``token_clip_coefficients`` (token granularity) and the
paper §6 one-pass oracles (``onepass_clipped_weight_grads*``).
"""
from repro_torch.core.passes import clip_coefficients

__all__ = ["clip_coefficients"]
