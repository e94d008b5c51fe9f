"""Provenance markers — identity calls that make the DP pipeline's
privacy-critical values identifiable in an analysis trace (DESIGN.md §12).

Port of ``src/repro/core/provenance.py``. The plan layer's DP invariants
(clip applied per example *before* the batch sum, noise injected exactly
once *after* the gradient all-reduce, no generator state drawn twice) are
properties of the program one ``Engine.step`` runs, but a recorded op list
gives the static analyzer nothing to anchor on: a clip coefficient is just
a ``clamp``, a noise sample just a ``mul_`` of a ``randn``. The reference
binds a JAX primitive that survives into the jaxpr; the port calls a
marker that returns its argument — the very object, with no dispatcher
call — and, inside an active analysis trace (``analysis._trace``), records
``(tag, meta, tensor identity)`` at its place in the op list:

  * ``clip_coef``  — the per-example (or per-token) clip coefficients,
    meta: clip_norm, eps, granularity;
  * ``grad_seed``  — a cotangent seed entering a backward pass, meta:
    kind ∈ {'plain', 'norms', 'weighted'} (weighted = the clip ×
    importance × user-weight product);
  * ``noise``      — one leaf's DP noise sample, meta: noise_std, scale,
    leaf index (and the segment of per-tenant noise);
  * ``rng_use``    — a ``torch.Generator`` at its point of consumption,
    meta: purpose + index (the single-use check of generator states hangs
    off these and the draws that follow them);
  * ``sample_idx`` — importance-sampling indices at the selection
    boundary;
  * ``grad_leaf``  — one summed-gradient leaf at the plan/optimizer
    boundary.

Outside a trace every marker returns at its first line. Marker placement
is production code (``core.passes``, ``core.plan``, ``core.clipping``,
``core.importance``); the analyzer only reads the records.

This module is also the one slot the rest of the package consults for the
active trace: the kernel wrappers (``kernels.ops``) and the data-parallel
all-reduces (``dist.pex``) hand a ``meta`` tensor to :func:`kernel_site` /
:func:`collective_site` instead of launching, which only a trace allows.
"""
from __future__ import annotations

from typing import Optional

import torch

#: known tags (an unknown tag in a trace is an analyzer error — it means a
#: marker was added without teaching the privacy pass about it)
TAG_CLIP = "clip_coef"
TAG_SEED = "grad_seed"
TAG_NOISE = "noise"
TAG_RNG = "rng_use"
TAG_SAMPLE = "sample_idx"
TAG_GLEAF = "grad_leaf"
KNOWN_TAGS = frozenset({TAG_CLIP, TAG_SEED, TAG_NOISE, TAG_RNG, TAG_SAMPLE,
                        TAG_GLEAF})

#: the active analysis trace's recorder (``analysis._trace.Recorder``), or
#: None. Set only by the recorder itself.
RECORDER = None


def tracing() -> bool:
    """Is an analysis trace recording?"""
    return RECORDER is not None


def _static(v):
    """Meta values are plain scalars; a tensor (rare) degrades to None
    rather than reading the device."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return None


def mark(x, tag: str, **meta):
    """Identity on ``x``; inside a trace, records ``(tag, meta)`` on it."""
    if RECORDER is not None:
        RECORDER.mark(x, tag, {k: _static(v) for k, v in meta.items()})
    return x


def mark_clip(c, *, clip_norm, eps, granularity: str):
    if RECORDER is None:
        return c
    return mark(c, TAG_CLIP, clip_norm=clip_norm, eps=eps,
                granularity=granularity)


def mark_seed(seed, *, kind: str):
    """kind: 'plain' (unweighted), 'norms' (the ones seed of the norms
    backward), 'weighted' (the clip × importance × user-weight product)."""
    if RECORDER is None:
        return seed
    return mark(seed, TAG_SEED, kind=kind)


def mark_noise(sample, *, noise_std, scale, leaf: int,
               segment: Optional[int] = None):
    if RECORDER is None:
        return sample
    return mark(sample, TAG_NOISE, noise_std=noise_std, scale=scale,
                leaf=leaf, segment=segment)


def mark_sample(indices, *, k: int):
    """Importance-sampling indices at the selection boundary. Selection
    lineage (which examples were drawn depends on the norms) is not
    *scaling* lineage, so the analyzer launders seed taint here."""
    if RECORDER is None:
        return indices
    return mark(indices, TAG_SAMPLE, k=k)


def mark_grad_leaf(g, *, leaf: int):
    """One summed-gradient leaf at the plan/optimizer boundary — after GNS
    reads the raw gradient, before noise and the apply."""
    if RECORDER is None:
        return g
    return mark(g, TAG_GLEAF, leaf=leaf)


def mark_grad_tree(grads):
    """``mark_grad_leaf`` over every leaf of a gradient tree, in its
    flattening order; the tree itself is returned."""
    if RECORDER is None:
        return grads
    from repro_torch.nn.param import tree_leaves
    for i, g in enumerate(tree_leaves(grads)):
        mark_grad_leaf(g, leaf=i)
    return grads


def mark_rng(gen, *, purpose: str, index: Optional[int] = None,
             seed: Optional[int] = None):
    """A ``torch.Generator`` at its point of consumption: the draws that
    follow from it are audited uses. ``seed`` is the integer a generator
    built inside the step was seeded from (it must come from a draw of a
    consumer's generator)."""
    if RECORDER is not None:
        RECORDER.mark_rng(gen, purpose, index, seed)
    return gen


def generator_device(device):
    """The device a step's own ``torch.Generator`` lives on: ``device``,
    except that a trace's ``meta`` tensors draw nothing, and a generator
    for them is a CPU one (its draws are recorded, never made)."""
    return "cpu" if torch.device(device).type == "meta" else device


def _recorder(what: str):
    if RECORDER is None:
        raise ValueError(f"{what}: a meta tensor reached a launch outside "
                         f"an analysis trace")
    return RECORDER


def kernel_site(name: str, inputs, outputs, **meta):
    """Record the launch a kernel wrapper would make on ``inputs`` (meta
    tensors) and return ``outputs`` (meta tensors of the kernel's output
    shapes) — the kernel runs nowhere."""
    _recorder(name).kernel(name, inputs, outputs, meta)
    return outputs


def collective_site(x: torch.Tensor, *, kind: str, count: int) -> None:
    """Record an ``all_reduce(SUM)`` of ``x`` in place over ``count`` data
    shards: ``kind`` "gather" (a zero-filled buffer of per-example rows)
    or "reduce" (a summed gradient leaf)."""
    _recorder("all_reduce").collective(x, kind, count)
