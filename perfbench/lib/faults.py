"""Faults a training cell can have, planted where the readings are made.

In the reference put in the program's place (keyword arguments of
``reference.train.follow``: ``alter`` changes each step's batch and
per-example loss scales, ``reweight`` the weight of each example in the
reweighted backward), for the upper readings taken on the chip:

- ``half_batch``: the second half of the batch left out and the first
  half's rows in its place, so the sum is B times the mean over the rest;
- ``altered_answer``: the first example's loss doubled where it is made;
- ``clip_weights_one`` (clipping cells): every clip weight set to 1 in
  the reweighted backward, the norms left sound;
- ``second_pass_half_batch`` (clipping cells): the reweighted backward
  over the first half of the batch, each weight doubled, the norms of the
  whole batch left sound.

In the program (context managers patching ``repro_torch`` underneath the
timed path), for the CPU test that sees ``correct`` come out false:

- ``unchanged``: the optimizer step returns its state unchanged;
- the four above, each where the reference plants it.

A one-chip cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch


def half_batch_rows(ids: torch.Tensor, labels: torch.Tensor):
    b = ids.shape[0]
    rows = torch.arange(b, device=ids.device) % (b // 2)
    return ids[rows], labels[rows]


def half_batch_ref(ids, labels):
    ids, labels = half_batch_rows(ids, labels)
    return ids, labels, [1.0] * ids.shape[0]


def altered_answer_ref(ids, labels):
    return ids, labels, [2.0] + [1.0] * (ids.shape[0] - 1)


def first_half_doubled(w: torch.Tensor) -> torch.Tensor:
    """(B,) weights → the first half's doubled, the second half's 0."""
    keep = torch.arange(w.shape[0], device=w.device) < w.shape[0] // 2
    return torch.where(keep, 2.0 * w, torch.zeros_like(w))


#: name → keyword arguments of ``reference.train.follow``
REFERENCE = {"half_batch": {"alter": half_batch_ref},
             "altered_answer": {"alter": altered_answer_ref}}
#: the same, for the cells that clip (a reweighted backward)
REFERENCE_CLIP = {
    "clip_weights_one": {"reweight": lambda j, b, w: 1.0},
    "second_pass_half_batch": {
        "reweight": lambda j, b, w: 2.0 * w if j < b // 2 else 0.0}}


@contextlib.contextmanager
def unchanged():
    from repro_torch.optim import adamw
    update = adamw.update
    adamw.update = lambda cfg, state, params, grads: (params, state)
    try:
        yield
    finally:
        adamw.update = update


@contextlib.contextmanager
def half_batch():
    from repro_torch.core.engine import Engine
    step = Engine.step

    def halved(self, loss_fn, params, batch, *args, **kwargs):
        ids, labels = half_batch_rows(batch["ids"], batch["labels"])
        return step(self, loss_fn, params, dict(batch, ids=ids,
                                                labels=labels),
                    *args, **kwargs)
    Engine.step = halved
    try:
        yield
    finally:
        Engine.step = step


@contextlib.contextmanager
def altered_answer():
    from repro_torch.models import transformer
    xent = transformer.per_example_xent

    def altered(*args, **kwargs):
        lv = xent(*args, **kwargs)
        scale = torch.ones_like(lv)
        scale[0] = 2.0
        return lv * scale
    transformer.per_example_xent = altered
    try:
        yield
    finally:
        transformer.per_example_xent = xent


@contextlib.contextmanager
def clip_weights_one():
    from repro_torch.core import plan
    coef = plan.clip_coefficients
    plan.clip_coefficients = lambda *args, **kwargs: \
        torch.ones_like(coef(*args, **kwargs))
    try:
        yield
    finally:
        plan.clip_coefficients = coef


@contextlib.contextmanager
def second_pass_half_batch():
    from repro_torch.core import plan
    compose = plan._compose_weights

    def halved(*args, **kwargs):
        w, tw, cc = compose(*args, **kwargs)
        return (None if w is None else first_half_doubled(w)), tw, cc
    plan._compose_weights = halved
    try:
        yield
    finally:
        plan._compose_weights = compose


PROGRAM = {"unchanged": unchanged, "half_batch": half_batch,
           "altered_answer": altered_answer}
PROGRAM_CLIP = {"clip_weights_one": clip_weights_one,
                "second_pass_half_batch": second_pass_half_batch}
