"""Training launcher: --arch <id> [--smoke] with the step modes.

Port of ``src/repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --mode clip --steps 50 [--device cpu]

``--arch`` is any arch of ``models.registry.ARCHS`` but
seamless-m4t-medium. The batches come from ``SyntheticLM`` (ids and labels
only, as in the reference), so qwen2-vl-7b trains there on its text-only
M-RoPE fallback, and seamless-m4t-medium, whose encoder needs the batch's
``src_frames``, is refused with an error that says so (the reference's
pipeline has no source frames either). It runs on the
CUDA device unless ``--device cpu`` is given, and raises when there is
none. ``--smoke`` runs the reduced config; without it the
published widths. ``--data-parallel``, ``--ckpt-dir`` and ``--resume`` are
refused: meshes and checkpointing wait for ROADMAP.md Queue 1 items 9 and
10.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import registry
from repro_torch.nn.param import count_params, resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.trainer import (WAITS, TrainConfig, Trainer,
                                       consumers_for_mode)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="norms",
                    choices=["plain", "norms", "clip", "importance"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--noise-std", type=float, default=0.0,
                    help="DP-SGD noise multiplier for --mode clip")
    ap.add_argument("--pex-method", default="auto")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    for flag, on in (("--data-parallel", args.data_parallel),
                     ("--ckpt-dir", args.ckpt_dir is not None),
                     ("--resume", args.resume)):
        if on:
            raise NotImplementedError(f"{flag} {WAITS}")

    aspec = registry.get(args.arch)
    if aspec.family == "seamless":
        raise ValueError(
            f"--arch {args.arch}: the encoder-decoder needs src_frames "
            f"(B, S, d_model) in every batch, and SyntheticLM gives ids and "
            f"labels only, as the reference's pipeline does; drive it "
            f"through Engine.step with registry.make_train_batch instead")
    device = resolve_device(args.device)
    cfg = aspec.smoke() if args.smoke else aspec.full()
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    print(f"{args.arch}: {count_params(params) / 1e6:.1f}M params, "
          f"mode={args.mode}, device={device}")
    trainer = Trainer(
        registry.make_loss_fn_v2(aspec, cfg),
        params, PexSpec(enabled=args.mode != "plain",
                        method=args.pex_method),
        adamw.AdamWConfig(lr=args.lr,
                          schedule=linear_warmup_cosine(10, args.steps)),
        TrainConfig(consumers=consumers_for_mode(
            args.mode, args.batch, clip_norm=args.clip_norm,
            noise_std=args.noise_std), steps=args.steps, seed=args.seed,
            # a run shorter than the log period still logs its last step
            log_every=min(10, args.steps)),
        DataConfig(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch,
                   seed=args.seed),
        device=device)
    return trainer.train()


if __name__ == "__main__":
    main()
