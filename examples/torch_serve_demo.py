"""Batched serving demo on the PyTorch port: prefill + step-locked decode
with slot recycling, on a reduced qwen2 config (GQA + QKV bias + KV cache).
Twin of ``examples/serve_demo.py``.

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.models import registry
from repro_torch.nn.param import resolve_device
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    device = resolve_device(ap.parse_args(argv).device)
    arch = "qwen2-7b"
    aspec = registry.get(arch)
    cfg = registry.serving_config(aspec, aspec.smoke(),
                                  ShapeSpec("demo", "decode", 64, 4))
    params = registry.family_module(aspec).init(
        cfg, torch.Generator(device=device).manual_seed(7), device=device)
    eng = Engine(arch, cfg, params, batch_slots=4, temperature=0.8,
                 device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab,
                                                         size=n)],
                    max_new=8) for n in (3, 7, 5, 4, 6, 2)]
    done = eng.generate(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: prompt={r.prompt} → out={r.out}")
    assert all(len(r.out) == r.max_new for r in done)
    print(f"\nserved {len(done)} requests in batches of 4 "
          f"(prefill + incremental decode, shared KV cache buffers)")
    return done


if __name__ == "__main__":
    main()
