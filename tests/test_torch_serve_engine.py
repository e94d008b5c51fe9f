"""The port's serving engine and launcher against the JAX reference's.

``Engine.generate`` with greedy sampling on llama3.2-1b and qwen2-7b smoke
gives the reference engine's tokens for the same requests (the reference's
parameters carried by ``interop``): two slots for three requests, so the
second batch recycles a slot; prompts of 3, 2 and 1 tokens, left-padded
with no mask, as the reference pads them; ``max_new`` 4, 6 and 3, so the
batch runs to its longest and trims the others. Temperature sampling
draws from the engine's own generator: one seed repeats its tokens,
another does not, and every token lies in the real vocab. The launcher
and ``examples/torch_serve_demo.py`` run on the CPU when asked, and raise
without a card when not.
"""
import dataclasses
import pathlib
import runpy

import jax
import numpy as np
import pytest
import torch

from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn.param import unbox
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import serve as tlaunch
from repro_torch.models import registry
from repro_torch.serve import Engine, Request

REPO = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [([1, 2, 3], 4), ([4, 5], 6), ([7], 3)]


def _pair(arch, edit=lambda cfg: cfg):
    jspec, spec = jreg.get(arch), registry.get(arch)
    jcfg = jreg.serving_config(jspec, edit(jspec.smoke()),
                               JShape("t", "decode", 32, 2))
    cfg = registry.serving_config(spec, edit(spec.smoke()),
                                  ShapeSpec("t", "decode", 32, 2))
    jparams = unbox(jreg.family_module(jspec).init(jax.random.PRNGKey(0),
                                                   jcfg))
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-7b"])
def test_greedy_generate_matches_reference_engine(arch):
    jcfg, cfg, jparams, params = _pair(arch)
    want = JEngine(arch, jcfg, jparams, batch_slots=2).generate(
        [JRequest(prompt=p, max_new=n) for p, n in PROMPTS])
    eng = Engine(arch, cfg, params, batch_slots=2, device="cpu")
    got = eng.generate([Request(prompt=p, max_new=n) for p, n in PROMPTS])
    assert [len(r.out) for r in got] == [4, 6, 3]
    assert [r.out for r in got] == [[int(t) for t in r.out] for r in want]
    again = Engine(arch, cfg, params, batch_slots=2, device="cpu").generate(
        [Request(prompt=[1, 2, 3], max_new=4)])
    assert again[0].out == got[0].out


def test_generate_stops_at_the_cache_length():
    """The decode loop runs min(max_new, max_cache_len - prompt length)
    steps, as the reference's does."""
    _, cfg, _, params = _pair("llama3.2-1b")
    cfg = dataclasses.replace(cfg, max_cache_len=6)
    done = Engine("llama3.2-1b", cfg, params, batch_slots=2,
                  device="cpu").generate([Request([1, 2, 3, 4], 9)])
    assert len(done[0].out) == 2


def test_temperature_sampling_repeats_per_seed_within_vocab():
    """A 131-token vocab (padded to 144): at temperature 50 the draw is
    near uniform, and no token lands in the padding."""
    arch = "llama3.2-1b"
    _, cfg, _, params = _pair(arch, lambda c: dataclasses.replace(
        c, vocab=131))
    assert cfg.vocab_cfg.vocab_p > cfg.vocab

    def run(seed):
        reqs = [Request(prompt=[5, 6, 7], max_new=24),
                Request(prompt=[8], max_new=24)]
        return [r.out for r in Engine(arch, cfg, params, batch_slots=2,
                                      temperature=50.0, seed=seed,
                                      device="cpu").generate(reqs)]
    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    toks = [t for out in a + c for t in out]
    assert all(0 <= t < cfg.vocab for t in toks)
    assert len(set(toks)) > 40


def test_launcher_runs_on_cpu_and_needs_a_card_otherwise(capsys):
    done = tlaunch.main(["--arch", "llama3.2-1b", "--smoke", "--requests",
                         "5", "--max-new", "6", "--slots", "2", "--device",
                         "cpu"])
    assert [len(r.out) for r in done] == [6] * 5
    assert "30 tokens for 5 requests" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.main(["--arch", "llama3.2-1b", "--smoke"])


def test_serve_demo_runs_on_cpu_and_needs_a_card_otherwise():
    demo = runpy.run_path(str(REPO / "examples" / "torch_serve_demo.py"),
                          run_name="demo")
    done = demo["main"](["--device", "cpu"])
    assert [len(r.out) for r in done] == [8] * 6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo["main"]([])
