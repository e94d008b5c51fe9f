"""CPU tests of the benchmark's harness: what a run loads, how it finds
its files, its formulas at small shapes, and the reference against the
port on small float32 configurations."""
from __future__ import annotations

import ast
import json
import math
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest

from perfbench.lib import check, runner, spec
from perfbench.lib.data import SyntheticTokens

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_run_module():
    import importlib.util
    s = importlib.util.spec_from_file_location(
        "perfbench_run", REPO / "perfbench" / "run.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_forbidden_names_are_compared_whole(monkeypatch):
    run = load_run_module()
    monkeypatch.setattr(sys, "modules", {
        "repro_torch": None, "repro_torch.core": None, "jaxtyping": None,
        "perfbench": None})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {
        "repro_torch": None, "repro.core": None, "jax.numpy": None,
        "jaxlib": None, "flax": None})
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax(small_root):
    """A whole run of a small cell on the CPU, in a fresh process, with
    the paths a run puts first: nothing in ``sys.modules`` at its end is
    JAX, jaxlib, flax or the JAX package."""
    code = textwrap.dedent(f"""
        import importlib.util, pathlib, sys, time
        sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
        from perfbench.lib import runner, spec
        s = importlib.util.spec_from_file_location(
            "perfbench_run", {str(REPO / 'perfbench' / 'run.py')!r})
        run = importlib.util.module_from_spec(s)
        s.loader.exec_module(run)
        cell = spec.load_cell("small-dense.dpsgd",
                              pathlib.Path({str(small_root)!r}))
        res = runner.run(cell, 7, 0.05, False, "cpu", time.perf_counter())
        print(res["correct"], run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "HOME": str(small_root)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_every_cell_finds_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], REPO)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["batch"] > 0 and cell.traffic["seq"] > 0
        assert cell.end_to_end and cell.per_layer
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert m.module.LAYER == m.entry["layer"]
            assert m.module.MOVES == m.entry["moves"]
        names = set(cell.limits)
        assert names >= {"loss_gap", "grad_gap", "update_gap"}
        assert ("norm_gap" in names) == runner.wants_norms(cell)
        assert ("clean_gap" in names) == runner.wants_noise(cell)


def test_a_cell_and_a_metric_are_added_by_files(small_root):
    """A configuration, a traffic mix, a cell and a per-layer metric
    added as files and entries, with no file of the harness edited."""
    pb = small_root / "perfbench"
    (pb / "metrics" / "tokens_per_step.py").write_text(textwrap.dedent("""
        UNIT = "tokens"
        BETTER = "higher"
        SOURCE = "host_clock"
        LAYER = "Step"
        MOVES = "tokens_per_s"


        def read(run):
            return run.tokens / run.steps if run.steps else None
    """))
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tokens_per_step", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "Step", "moves": "tokens_per_s",
        "workloads": ["small-dense.plain"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("small-dense.plain", small_root)
    extra = [m for m in cell.per_layer if m.name == "tokens_per_step"]
    assert extra
    res = runner.run(cell, 11, 0.05, False, "cpu", time.perf_counter())
    assert extra[0].read(res["run"]) == 4 * 64
    other = spec.load_cell("small-dense.dpsgd", small_root)
    assert "tokens_per_step" not in {m.name for m in other.per_layer}


def test_every_family_has_its_reference():
    """A family is files found by its name: ``families/<family>.py`` for
    the program's side, ``reference/<family>.py`` for the reference's."""
    import importlib
    fams = [p.stem for p in (REPO / "perfbench" / "families").glob("*.py")
            if p.stem != "__init__"]
    assert fams
    for fam in fams:
        prog = importlib.import_module(f"perfbench.families.{fam}")
        ref = importlib.import_module(f"perfbench.reference.{fam}")
        for name in ("program_config", "schema", "check_layout", "loss_fn",
                     "reading_routes"):
            assert callable(getattr(prog, name)), (fam, name)
        assert callable(ref.follow)


def test_a_metric_that_disagrees_with_its_entry_is_refused(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["end_to_end"][0]["unit"] = "tokens/min"
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="declares"):
        spec.load_cell("small-dense.plain", small_root)


def _metric(name):
    return spec.load_metric(REPO, {"name": name, "unit": "%",
                                   "better": "higher",
                                   "source": "host_clock"
                                   if name == "step_mfu" else
                                   "device_trace"}).module


def test_model_flops_by_hand():
    mfu = _metric("step_mfu")
    c = {"hidden_size": 8, "intermediate_size": 16, "head_dim": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 10, "num_hidden_layers": 3}
    # attention 8·8 + 2·8·4 + 8·8 = 192, MLP 3·8·16 = 384, head 80
    assert mfu.matmul_params_per_token(c) == 3 * (192 + 384) + 80
    # 6·N·S + layers · 6·S²·H·D at S = 5
    assert mfu.flops_per_sequence(c, 5) == 6 * 1808 * 5 + 3 * 6 * 25 * 8
    moe = dict(c, num_local_experts=4, num_experts_per_tok=2)
    # top-2 of the experts' 3·8·16 and the router's 8·4
    assert mfu.matmul_params_per_token(moe) == 3 * (192 + 768 + 32) + 80


def test_norm_work_by_hand():
    nr = _metric("norm_roofline")
    # S = 4, p_in = 3, p_out = 5: gram 4·5·8 + 32 = 192; direct
    # 2·4·15 + 30 = 150: the fewer
    assert nr.site_ops(4, 3, 5) == 150
    assert nr.site_ops(2, 64, 64) == 2 * 3 * 128 + 8
    c = {"hidden_size": 1024, "intermediate_size": 4096, "head_dim": 128,
         "num_attention_heads": 8, "num_key_value_heads": 2,
         "vocab_size": 32000, "num_hidden_layers": 1,
         "run": {"dtype": "bfloat16"}}
    b, s = 2, 256
    t = nr.least_seconds(c, b, s)
    ops = b * (2 * nr.site_ops(s, 1024, 1024) + 2 * nr.site_ops(s, 1024, 256)
               + 2 * nr.site_ops(s, 1024, 4096)
               + nr.site_ops(s, 4096, 1024) + nr.site_ops(s, 1024, 32000))
    assert t >= ops / 989e12
    assert t <= 1.05 * (ops / 989e12 + 2 * b * s * (6 * 1024 + 3 * 4096
                                                     + 512 + 32000) / 3.35e12)


def test_norm_kernels_are_every_kernel_the_norm_sources_launch():
    """``norm_roofline`` times every kernel the gram, direct and segmented
    sources launch (their partial sums' reduction too), and nothing
    else."""
    import re
    nr = _metric("norm_roofline")
    csrc = REPO / "src" / "repro_torch" / "csrc"
    launched = set()
    for name in ("gram_norm", "direct_norm", "segmented_norm"):
        text = (csrc / f"{name}.cu").read_text()
        launched |= set(re.findall(r"(\w+)\s*(?:<[\w:, ]*>)?\s*<<<", text))
    assert launched
    timed = set(re.findall(r"\w+", nr.KERNELS.replace(r"\b", " ")))
    assert launched <= timed, launched - timed
    for name in ("rowsumsq", "clip_scale", "flash_attention"):
        text = (csrc / f"{name}.cu").read_text()
        for k in re.findall(r"(\w+)\s*(?:<[\w:, ]*>)?\s*<<<", text):
            assert not re.search(nr.KERNELS, k), k


def test_flash_work_by_hand():
    fr = _metric("flash_roofline")
    c = {"head_dim": 128, "num_attention_heads": 32,
         "num_key_value_heads": 8, "num_hidden_layers": 2,
         "run": {"dtype": "bfloat16"}}
    b, s = 1, 4096
    core = b * 32 * s * s * 128
    assert fr.least_seconds(c, b, s) == pytest.approx(
        2 * (2 * core + 4 * core) / 989e12)


def test_leaf_gap_counts_leaves_by_the_reference_gradient():
    keep = check.counted_leaves([1.0, 2.0, 3.0, 1e-5])
    assert keep == [0, 1, 2]
    # a leaf's gap is over the larger of its own norm and the median's
    assert check.leaf_gap([1.1, 2.0, 3.0], [1.0, 2.0, 3.0], keep) \
        == pytest.approx(0.05)
    assert check.leaf_gap([1.0], [1.0, 2.0], [0]) == math.inf


def test_tokens_are_a_function_of_seed_and_step():
    a = SyntheticTokens(100, 3, 16, 2**31 + 5, device="cpu")
    b = SyntheticTokens(100, 3, 16, 2**31 + 5, device="cpu")
    assert (a.batch_at(4)["ids"] == b.batch_at(4)["ids"]).all()
    assert not (a.batch_at(4)["ids"] == a.batch_at(5)["ids"]).all()
    ids, labels = a.arrays(0)
    assert (labels[:, :-1] == ids[:, 1:]).all()


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {n}"
                if n.split(".")[0] == "perfbench":
                    assert n.startswith("perfbench.reference"), n


@pytest.mark.parametrize("cell", ["small-dense.dpsgd", "small-moe.dpsgd",
                                  "small-dense.plain"])
def test_the_port_agrees_with_the_reference(small_root, cell):
    """The whole run on the CPU at a small float32 configuration: the
    port's checked steps against the reference's, within 1e-3 each."""
    c = spec.load_cell(cell, small_root)
    res = runner.run(c, 2**31 + 99, 0.05, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert len(res["program"]["loss"]) == c.traffic["check_steps"]
