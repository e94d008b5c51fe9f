"""Serving launcher: --arch <id> [--smoke], batched random requests.

Port of ``src/repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke [--device cpu]

Random parameters (seed 0) and random prompts of 2 to 11 tokens (numpy
seed 1), decoded at temperature 0.8 through ``serve.Engine``; prints the
tokens, the requests and the tokens per second. It runs on the CUDA device
unless ``--device cpu`` is given, and raises when there is none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.models import registry
from repro_torch.nn.param import resolve_device
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    aspec = registry.get(args.arch)
    base = aspec.smoke() if args.smoke else aspec.full()
    cfg = registry.serving_config(
        aspec, base, ShapeSpec("serve", "decode", args.cache_len, args.slots))
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    eng = Engine(args.arch, cfg, params, batch_slots=args.slots,
                 temperature=0.8, device=device)

    rng = np.random.default_rng(1)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                         size=int(n))],
                    max_new=args.max_new)
            for n in rng.integers(2, 12, size=args.requests)]
    t0 = time.perf_counter()
    done = eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"{tokens} tokens for {len(done)} requests in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
