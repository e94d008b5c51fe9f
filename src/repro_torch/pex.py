"""``repro_torch.pex`` — the public namespace of the PyTorch port.

Port of ``src/repro/pex.py`` for this slice:

    from repro_torch import pex

    eng = pex.Engine(pex.PexSpec())
    res = eng.step(loss_fn, params, batch,
                   consumers=[pex.Clip(1.0), pex.Noise(0.5, gen), pex.GNS()])

with models written against the tap collector (``tap.dense``,
``tap.scale``, ``tap.embedding``, ...). ``pex.NULL`` is the inert tap for
oracle paths. Not yet here: ``scan``/``checkpoint``.
"""
from repro_torch.core.clipping import (clip_coefficients,
                                       token_clip_coefficients)
from repro_torch.core.engine import Engine, infer_batch_size, infer_seq_len
from repro_torch.core.passes import PexResult
from repro_torch.core.plan import (GNS, Clip, Grads, Importance, Noise, Norms,
                                   StepResult, gradient_noise_scale)
from repro_torch.core.taps import (DISABLED, NULL, ExampleLayout, PexSpec, Tap,
                                   TokenLayout)

__all__ = [
    "Engine", "PexResult", "PexSpec", "Tap", "ExampleLayout", "TokenLayout",
    "DISABLED", "NULL", "clip_coefficients", "token_clip_coefficients",
    "infer_batch_size", "infer_seq_len",
    "Norms", "Grads", "Clip", "Noise", "Importance", "GNS", "StepResult",
    "gradient_noise_scale",
]
