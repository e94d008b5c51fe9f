"""Importance-sampled optimization (Zhao & Zhang 2014 — the paper's §1
motivation) on the PyTorch port: train a ~100M-param llama-family model
against a uniform baseline at the same number of optimizer steps. The twin
of ``examples/importance_training.py``, without its checkpointing, which
waits for the port's checkpoint layer (ROADMAP.md Queue 1 item 10).

    PYTHONPATH=src python examples/torch_importance_training.py \
        [--steps 200] [--device cpu]
"""
import argparse

import torch

from repro_torch import pex
from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import registry
from repro_torch.models.transformer import LMConfig
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MlpCfg
from repro_torch.nn.param import count_params, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.trainer import TrainConfig, Trainer


def model_100m():
    """~100M params: 8L, d=512, llama-style."""
    return LMConfig(
        name="llama-100m", n_layers=8, d_model=512, vocab=32768,
        attn=AttnCfg(d_model=512, n_heads=8, n_kv=4, head_dim=64,
                     head_multiple=1),
        mlp=MlpCfg(d_model=512, d_ff=2048), dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    aspec = registry.get("llama3.2-1b")          # family entry points
    cfg = model_100m()
    mod = registry.family_module(aspec)
    params = mod.init(cfg, torch.Generator(device=args.device).manual_seed(0),
                      device=args.device)
    print(f"params: {count_params(params) / 1e6:.1f}M on {args.device}")

    spec = PexSpec(enabled=True, method="auto")
    loss_fn = registry.make_loss_fn_v2(aspec, cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq=args.seq,
                      global_batch=args.batch, seed=11)
    ocfg = adamw.AdamWConfig(
        lr=1e-3, schedule=linear_warmup_cosine(20, args.steps))

    # Importance = norms on the 4x pool → sample ∝ ‖∇L_j‖ → ONE weighted
    # backward on the sub-batch. The uniform baseline is the classic
    # grads+norms fused step.
    plans = {
        "importance": (pex.Importance(args.batch // 4, smoothing=0.2),
                       pex.Grads()),
        "norms": (pex.Norms(), pex.Grads()),
    }
    results = {}
    for mode, consumers in plans.items():
        # the optimizer updates in place: each mode trains its own copy
        t = Trainer(loss_fn, tree_map(torch.clone, params), spec, ocfg,
                    TrainConfig(consumers=consumers, steps=args.steps,
                                log_every=25),
                    dcfg, device=args.device)
        how = ("pool=4x, sample ∝ ‖∇L_j‖" if mode == "importance"
               else "uniform")
        print(f"\n=== mode={mode} ({how}) ===")
        ms = t.train()
        # the importance plan reports the candidate-POOL loss (its norms
        # pass computes it), so both modes normalize by pool tokens
        tok = args.batch * args.seq
        final = sum(m["loss"] for m in ms[-10:]) / len(ms[-10:]) / tok
        results[mode] = final
        print(f"final loss/token: {final:.4f}")

    print(f"\nimportance={results['importance']:.4f} "
          f"uniform={results['norms']:.4f} "
          f"(importance uses 4x-smaller gradient batches picked by norm)")


if __name__ == "__main__":
    main()
