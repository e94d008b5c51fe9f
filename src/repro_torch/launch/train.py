"""Training launcher: --arch <id> [--smoke] with the step modes.

Port of ``src/repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --mode clip --steps 50 [--device cpu] [--data-parallel] \
        [--ckpt-dir DIR [--resume]]

``--arch`` is any arch of ``models.registry.ARCHS`` but
seamless-m4t-medium. The batches come from ``SyntheticLM`` (ids and labels
only, as in the reference), so qwen2-vl-7b trains there on its text-only
M-RoPE fallback, and seamless-m4t-medium, whose encoder needs the batch's
``src_frames``, is refused with an error that says so (the reference's
pipeline has no source frames either). It runs on the
CUDA device unless ``--device cpu`` is given, and raises when there is
none. ``--smoke`` runs the reduced config; without it the
published widths.

``--data-parallel`` trains on a ``("data", "model")`` host mesh
(``launch.mesh.make_host_mesh``) through ``dist.pex``, one process per
rank. Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``)
each process joins that group; otherwise the launcher spawns one rank per
visible CUDA device, or a single rank with ``--device cpu``. The backend
follows the device: NCCL on CUDA (rank r on ``cuda:LOCAL_RANK``), gloo on
the CPU. The first rank logs, and ``main`` returns its metrics.

``--ckpt-dir DIR`` checkpoints into DIR every ``TrainConfig.ckpt_every``
(50) steps and at no other step, as the reference's launcher does;
``--resume`` restores the newest restorable step of DIR first and trains on
to ``--steps``. With ``--data-parallel`` the first rank writes and every
rank restores (``train.trainer``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.core.taps import PexSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import registry
from repro_torch.nn.param import count_params, resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.trainer import (TrainConfig, Trainer,
                                       consumers_for_mode)

_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _parse(argv):
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
    ap.add_argument("--data-parallel", action="store_true",
                    help="split the batch over one process per rank "
                         "(dist.pex; NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = _parse(argv)
    aspec = registry.get(args.arch)
    if aspec.family == "seamless":
        raise ValueError(
            f"--arch {args.arch}: the encoder-decoder needs src_frames "
            f"(B, S, d_model) in every batch, and SyntheticLM gives ids and "
            f"labels only, as the reference's pipeline does; drive it "
            f"through Engine.step with registry.make_train_batch instead")
    device = resolve_device(args.device)
    if not args.data_parallel:
        return _train(args, device)
    if all(k in os.environ for k in _TORCHRUN):
        return _rank(int(os.environ["LOCAL_RANK"]), argv,
                     int(os.environ["WORLD_SIZE"]), "env://", None)
    world = torch.cuda.device_count() if device.type == "cuda" else 1
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(argv, world,
                                        f"file://{tmp}/store", tmp),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(tmp, "metrics.json")) as f:
            return json.load(f)


def _rank(local_rank: int, argv, world: int, init_method: str,
          out_dir) -> list:
    """One data-parallel rank: join the group, train on the host mesh,
    leave the group. The first rank logs and, when spawned, writes its
    metrics to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    args = _parse(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    rank = int(os.environ.get("RANK", local_rank))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh(device_type=device.type)
        if rank == 0:
            print(f"data-parallel over {mesh.size(0)} ranks "
                  f"({dist.get_backend()}, {device.type})", flush=True)
        metrics = _train(args, device, mesh=mesh, log=rank == 0)
    finally:
        dist.destroy_process_group()
    if out_dir is not None and rank == 0:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f)
    return metrics


def _train(args, device, mesh=None, log=True) -> list:
    aspec = registry.get(args.arch)
    cfg = aspec.smoke() if args.smoke else aspec.full()
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    if log:
        print(f"{args.arch}: {count_params(params) / 1e6:.1f}M params, "
              f"mode={args.mode}, device={device.type}", flush=True)
    trainer = Trainer(
        registry.make_loss_fn_v2(aspec, cfg),
        params, PexSpec(enabled=args.mode != "plain",
                        method=args.pex_method),
        adamw.AdamWConfig(lr=args.lr,
                          schedule=linear_warmup_cosine(10, args.steps)),
        TrainConfig(consumers=consumers_for_mode(
            args.mode, args.batch, clip_norm=args.clip_norm,
            noise_std=args.noise_std), steps=args.steps, seed=args.seed,
            ckpt_dir=args.ckpt_dir,
            # a run shorter than the log period still logs its last step
            log_every=min(10, args.steps) if log else 0),
        DataConfig(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch,
                   seed=args.seed),
        mesh=mesh, device=device)
    return trainer.train(resume=args.resume)


if __name__ == "__main__":
    main()
