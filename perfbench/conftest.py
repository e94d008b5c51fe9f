"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
folder holding ``BENCHMARK.json`` and ``perfbench/`` as the repository
has them, plus small float32 copies of the two configurations, each under
the DP-SGD and the plain traffic at a few rows of 64 tokens, so that the
whole run (the program's steps, the window, the reference) takes seconds
on the CPU."""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

SMALL = {"hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 96, "num_hidden_layers": 2}

#: limits of the small float32 cells: the program and the reference agree
#: to ~1e-6 there, the FP8 control and the faults miss by 1e-2 or more
SMALL_LIMITS = {"loss_gap": 1e-3, "norm_gap": 1e-3, "grad_gap": 1e-3,
                "clean_gap": 1e-3, "update_gap": 1e-3, "route_gap": 1e-3}


def small_config(name: str, base: str) -> dict:
    c = json.loads((REPO / "perfbench" / "configs" / f"{base}.json")
                   .read_text())
    c.update(SMALL, name=name)
    c["run"] = dict(c["run"], dtype="float32", head_multiple=2)
    if c.get("num_local_experts"):
        c["num_local_experts"] = 4
    return c


def small_traffic(base: str) -> dict:
    t = json.loads((REPO / "perfbench" / "traffic" / f"{base}.json")
                   .read_text())
    t.update(batch=4, seq=64, check_steps=2)
    return t


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout root with the repository's benchmark and the small
    cells ``small-dense.dpsgd``, ``small-moe.dpsgd`` and
    ``small-dense.plain`` added as files and entries."""
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = tmp / "perfbench"
    for name, base in (("small-dense", "qwen2-7b"),
                       ("small-moe", "phi3.5-moe")):
        (pb / "configs" / f"{name}.json").write_text(
            json.dumps(small_config(name, base)))
        bench["configs"].append(
            {"name": name, "source": "a small copy", "reduced": [],
             "file": f"perfbench/configs/{name}.json", "why": "tests"})
    for name, base in (("small-dpsgd", "dpsgd-s512"),
                       ("small-plain", "plain-s512")):
        (pb / "traffic" / f"{name}.json").write_text(
            json.dumps(small_traffic(base)))
    for cell, conf, traffic in (
            ("small-dense.dpsgd", "small-dense", "small-dpsgd"),
            ("small-moe.dpsgd", "small-moe", "small-dpsgd"),
            ("small-dense.plain", "small-dense", "small-plain")):
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "tests"})
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": SMALL_LIMITS}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)
