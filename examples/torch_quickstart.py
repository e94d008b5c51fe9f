"""Quickstart on the PyTorch port: per-example gradient norms for free
(Goodfellow 2015).

Builds the small llama-family config, runs ONE backward pass through the
port's ``Engine`` that yields both the parameter gradients and every
example's gradient norm, and cross-checks against the naive per-example
method (paper §3). The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.core import naive
from repro_torch.models import registry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    arch = registry.get("llama3.2-1b")
    cfg = arch.smoke()                      # reduced config
    params = registry.family_module(arch).init(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        device=args.device)
    B, S = 8, 32
    batch = registry.make_train_batch(arch, cfg, ShapeSpec("q", "train", S, B),
                                      device=args.device)

    # Instrumentation is declared ONCE on the Engine; the model receives a
    # Tap collector and every dense layer registers (H, Z̄) with it.
    eng = pex.Engine(pex.PexSpec(method="auto"))
    loss_fn = registry.make_loss_fn_v2(arch, cfg)

    # ONE backward pass yields grads + all per-example squared norms
    # (§4–§5).
    res = eng.step(loss_fn, params, batch,
                   consumers=[pex.Norms(), pex.Grads()])
    norms = torch.sqrt(torch.sum(res.sq_norms, -1))
    print(f"loss = {float(res.loss):.3f} on {args.device}")
    print("per-example ‖∇L_j‖ :", [round(x, 2) for x in norms.tolist()])

    # Cross-check vs the naive method the paper replaces (§3): the same
    # model with the inert tap is the plain, uninstrumented network.
    def single(p, ex):
        b1 = {k: v[None] for k, v in ex.items()}
        return loss_fn(p, b1, pex.NULL)[0][0]

    oracle = torch.sqrt(naive.per_example_sq_norms(single, params, batch))
    err = float(torch.max(torch.abs(norms - oracle) / oracle))
    print(f"max rel err vs naive per-example backprop: {err:.2e}")
    assert err < 1e-4
    print("OK — exact, in one backward pass.")


if __name__ == "__main__":
    main()
