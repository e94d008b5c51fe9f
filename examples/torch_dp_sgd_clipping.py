"""Per-example gradient clipping (paper §6) as DP-SGD on the PyTorch port:
clip every example's gradient to C, add Gaussian noise σ·C, train —
declared as a consumer plan that the Engine runs as one tapped forward,
one norms backward and one reweighted backward, with gradient-noise-scale
telemetry riding along. No per-example gradient is ever materialized. The
twin of ``examples/dp_sgd_clipping.py``.

    PYTHONPATH=src python examples/torch_dp_sgd_clipping.py [--device cpu]
"""
import argparse

import torch

from repro_torch import pex
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    aspec = registry.get("llama3.2-1b")
    cfg = aspec.smoke()
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        device=args.device)
    spec = pex.PexSpec(method="auto")
    loss_fn = registry.make_loss_fn_v2(aspec, cfg)

    # the step IS the consumer list: clipping, DP noise and GNS telemetry
    # off one fused pass (the trainer gives Noise a generator each step)
    consumers = (pex.Norms(), pex.Clip(0.5), pex.Noise(0.1), pex.GNS())
    t = Trainer(loss_fn, params, spec, adamw.AdamWConfig(lr=1e-3),
                TrainConfig(consumers=consumers, steps=args.steps,
                            log_every=10),
                DataConfig(vocab=cfg.vocab, seq=64, global_batch=16),
                device=args.device)
    ms = t.train()
    print(f"\nfinal loss {ms[-1]['loss']:.2f}; "
          f"max per-example norm seen {max(m['norm_max'] for m in ms):.2f} "
          f"(every example's contribution clipped to 0.5); "
          f"B_simple last step {ms[-1]['gns']:.3g}")

    # the §6 semantics directly: post-clip per-example influence
    eng = pex.Engine(spec)
    batch = t.data.batch_at(0)
    gen = torch.Generator(device=args.device).manual_seed(1)
    res = eng.step(loss_fn, t.params, batch,
                   consumers=[pex.Clip(0.5), pex.Noise(0.1, gen)])
    print("clip coefficients c_j:",
          [round(x, 3) for x in res.clip_coef.tolist()])

    # per-TOKEN clipping is the same consumer at token granularity: each
    # token's loss term is reweighted by its own (B, S) contribution norm
    res_t = eng.step(loss_fn, t.params, batch,
                     consumers=[pex.Clip(0.5, granularity="token"),
                                pex.Grads()])
    c = res_t.token_weights
    print(f"per-token clip: {float((c < 1.0).float().mean()) * 100:.0f}% of "
          f"tokens clipped (coefficient map shape {tuple(c.shape)})")


if __name__ == "__main__":
    main()
