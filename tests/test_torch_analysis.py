"""The port's static analysis (``repro_torch.analysis``) against the
reference's pexlint passes, on the CPU at smoke configs.

  * Coverage: for each of the ten archs, every parameter's status (tapped /
    untapped-but-trained / frozen, allowlisted) equals the reference's
    ``trace_coverage`` status for the same parameter — the reference's
    stacked (L, ...) leaves reach the port's per-layer leaves through
    ``interop.params_from_numpy`` of a tree whose every leaf holds its own
    index — and the distinct Tap-site (op, operand shapes) sets are equal.
    A deleted Tap site (the first tap call, and the first ``dense``) is
    flagged on the same parameters as the reference flags it.
  * Privacy: the clean DP step is ok, and each flow mutant of
    ``tests/test_pexlint_mutation.py``, rebuilt in the port
    (``tests/torch_analysis_parity.py``), reports the finding code that
    the reference's mutation test asserts for its own mutant
    (``REFERENCE_CODES``; those reference traces are built there, not
    again here).
  * Collectives: one spawned group of two gloo ranks records the DP step
    over a (2, 1) host mesh: the clean step's schedule equals the
    reference's ``expected_schedule`` and both mesh mutants report the
    reference's codes. The reference's own collectives pass does not run
    under jax 0.9.0 (its shard_map walk reads ``out_names``), so it is no
    yardstick for the trace itself.
  * Determinism: both checkers are clean on their own sources, and each
    mutant source (a wall-clock read, a global draw, a write to ``self`` in
    the replay path, the seed drift, the reference's rule snippets) trips
    the same code in both.
"""
import inspect
import json

import jax
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.analysis import collectives as jcol
from repro.analysis import coverage as jcov
from repro.analysis import determinism as jdet
from repro.core import plan as jplan
from repro.models import registry as jreg
from repro_torch import interop
from repro_torch.analysis import coverage as cov
from repro_torch.analysis import determinism as det
from repro_torch.analysis import privacy as priv
from repro_torch.analysis.verify import verify
from repro_torch.analysis.__main__ import lint_config, main as lint_main
from repro_torch.core.taps import Tap
from repro_torch.models import registry
from repro_torch.nn.param import tree_leaves

from tests import torch_analysis_parity as tap
from tests import torch_dist_parity as tdp
from tests.test_pexlint import abstract_setup
from tests.test_pexlint_mutation import MutantTap as JMutantTap

ARCHS = sorted(jreg.ARCHS)

#: the code ``tests/test_pexlint_mutation.py`` asserts on each of its flow
#: mutants (privacy, except per_example_psum: collectives)
REFERENCE_CODES = {"noise_before_psum": "noise-before-psum",
                   "double_noise": "double-noise",
                   "unclipped_leaf": "unclipped-leaf",
                   "reused_key": "key-reuse",
                   "per_example_psum": "per-example-psum",
                   "seed_drift": "seed-ignores-step"}


class MutantTap(Tap):
    """The port's counterpart of the reference's ``MutantTap``: drops its
    ``kill``-th tap call (trace order) to the uninstrumented op."""
    __slots__ = ("kill", "count", "_inner")

    def __init__(self, spec, acc=None, layout=None, kill=-1):
        super().__init__(spec, acc, layout)
        self.kill = kill
        self.count = 0
        self._inner = False

    def _dead(self) -> bool:
        k = self.count
        self.count += 1
        return k == self.kill

    def dense(self, h, w, **kw):
        if self._dead():
            return torch.matmul(h, w)
        return super().dense(h, w, **kw)

    def bias_add(self, x, b, **kw):
        if self._dead():
            return x + b
        return super().bias_add(x, b, **kw)

    def scale(self, h, g, **kw):
        if self._dead():
            return h * g
        return super().scale(h, g, **kw)

    def embedding(self, table, ids, **kw):
        if self._dead():
            return table[ids]
        return super().embedding(table, ids, **kw)

    def dense_expert(self, x, w, seg, tok=None, **kw):
        if self._dead():
            return torch.einsum("ecd,edf->ecf", x, w)
        self._inner = True          # its grouped op is the same call
        try:
            return super().dense_expert(x, w, seg, tok, **kw)
        finally:
            self._inner = False

    def dense_expert_grouped(self, x, w, seg, bg, tok=None, **kw):
        if not self._inner and self._dead():
            return torch.einsum("gecd,edf->gecf", x, w)
        return super().dense_expert_grouped(x, w, seg, bg, tok, **kw)


@pytest.fixture(scope="module")
def archs():
    """Per arch: the reference's setup and clean coverage, and the port's
    loss, index-carrying parameters (each leaf filled with the index of
    the reference leaf it came from), batch and clean coverage."""
    out = {}
    for arch in ARCHS:
        _, jloss, jparams, jbatch = abstract_setup(arch)
        jrep = jcov.trace_coverage(jloss, jparams, jbatch,
                                   allow=jreg.untapped_allowlist(arch))
        flat, tdef = jax.tree_util.tree_flatten(jparams)
        idx = jax.tree_util.tree_unflatten(
            tdef, [np.full(x.shape, i, np.float32)
                   for i, x in enumerate(flat)])
        params = interop.params_from_numpy(idx, device="cpu")
        _, _, loss_fn, _, batch = lint_config(arch)
        rep = cov.trace_coverage(loss_fn, params, batch,
                                 allow=registry.untapped_allowlist(arch))
        out[arch] = dict(jloss=jloss, jparams=jparams, jbatch=jbatch,
                         jrep=jrep, loss_fn=loss_fn, params=params,
                         batch=batch, rep=rep)
    return out


def _ref_index(params):
    """The reference leaf index each port leaf carries (None for empty)."""
    return [int(x.reshape(-1)[0]) if x.numel() else None
            for x in tree_leaves(params)]


def _site_set(rep):
    return {(s.op, tuple(a[0] for a in s.operand_avals)) for s in rep.sites}


@pytest.mark.parametrize("arch", ARCHS)
def test_coverage_statuses_match_reference(archs, arch):
    a = archs[arch]
    want = {i: (l.status, l.allowlisted)
            for i, l in enumerate(a["jrep"].leaves)}
    got = list(zip(_ref_index(a["params"]), a["rep"].leaves))
    assert len(got) >= len(want)
    for i, leaf in got:
        if i is not None:
            assert (leaf.status, leaf.allowlisted) == want[i], leaf.path
    assert {i for i, _ in got} >= set(want)
    assert a["rep"].ok and a["jrep"].ok
    assert a["rep"].counts()[cov.TAPPED] > 0
    assert a["rep"].stale_allow == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_tap_sites_match_reference(archs, arch):
    a = archs[arch]
    assert _site_set(a["rep"]) == _site_set(a["jrep"])


def _first(rep, op):
    return next(i for i, s in enumerate(rep.sites) if s.op == op)


@pytest.mark.parametrize("arch", ARCHS)
def test_deleted_tap_site_flagged_as_reference(archs, arch):
    """Kill the first tap call, then the first ``dense`` call, in both
    packages: the same parameters (by reference leaf) are flagged."""
    a = archs[arch]
    index = _ref_index(a["params"])
    jpaths = [l.path for l in a["jrep"].leaves]
    for jk, k in ((0, 0), (_first(a["jrep"], "dense"),
                           _first(a["rep"], "dense"))):
        jrep = jcov.trace_coverage(
            a["jloss"], a["jparams"], a["jbatch"],
            allow=jreg.untapped_allowlist(arch),
            tap_factory=lambda spec, acc=None, layout=None:
                JMutantTap(spec, acc, layout, kill=jk))
        rep = cov.trace_coverage(
            a["loss_fn"], a["params"], a["batch"],
            allow=registry.untapped_allowlist(arch),
            tap_factory=lambda spec, acc=None, layout=None:
                MutantTap(spec, acc, layout, kill=k))
        assert not rep.ok and not jrep.ok
        flagged = {jpaths[index[i]] for i, l in enumerate(rep.leaves)
                   if l.is_error}
        assert flagged == {l.path for l in jrep.errors}


# ---------------------------------------------------------------------------
# privacy: the clean step and the local mutants
# ---------------------------------------------------------------------------

def _codes(report):
    return {f.code for f in report.findings}


def test_privacy_clean_step_is_ok():
    rep = priv.analyze_trace(tap.dp_trace())
    assert rep.ok, rep.summary()
    by_tag = {}
    for m in rep.marks:
        by_tag[m.tag] = by_tag.get(m.tag, 0) + 1
    n = len(rep.leaves)
    assert by_tag["clip_coef"] == 1 and by_tag["noise"] == n
    assert all(len(l.noise_tokens) == 1 for l in rep.leaves)


@pytest.mark.parametrize("mutant", ["double_noise", "unclipped_leaf",
                                    "reused_key"])
def test_privacy_mutant_codes_match_reference(mutant):
    with getattr(tap, mutant)():
        rep = priv.analyze_trace(tap.dp_trace())
    assert not rep.ok
    assert REFERENCE_CODES[mutant] in _codes(rep), rep.summary()


def test_privacy_importance_and_token_steps_are_clean():
    from repro_torch import pex
    _, _, loss_fn, params, batch = lint_config("phi3.5-moe")
    gen = torch.Generator().manual_seed(0)
    for cons, gran in (([pex.Importance(2, rng=gen), pex.Clip(1.0),
                         pex.Noise(0.1, gen)], "example"),
                       ([pex.Clip(1.0, granularity="token"),
                         pex.Noise(0.1, gen, scale=1.0)], "token")):
        from repro_torch.analysis import _trace
        rep = priv.analyze_trace(_trace.trace_step(
            loss_fn, params, batch, cons, granularity=gran))
        assert rep.ok, rep.summary()


# ---------------------------------------------------------------------------
# collectives: one spawned group of two gloo ranks
# ---------------------------------------------------------------------------

def test_collectives_two_gloo_ranks_match_reference(tmp_path):
    res = tdp.spawn(tmp_path, 2, tap.collectives_rank)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    plan = jplan.analyze([jpex.Clip(1.0),
                          jpex.Noise(0.1, jax.random.PRNGKey(0))])
    want = [(e.output, e.per_example, e.psum_axes)
            for e in jcol.expected_schedule(plan, mesh, ("data",))]
    for r in res:
        assert r == res[0]
        assert [tuple(e) for e in r["schedule"]] == want
        assert r["clean"] == {"collectives": [], "privacy": []}
        assert r["grad_sums"] == [1]
        assert all(count == 2 for _, _, count, _ in r["reduces"])
        assert all(sums == 0 for _, per_ex, sums in r["outputs"] if per_ex)
        assert REFERENCE_CODES["noise_before_psum"] in \
            r["noise_before_psum"]["privacy"]
        assert REFERENCE_CODES["per_example_psum"] in \
            r["per_example_psum"]["collectives"]


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def _sources():
    import repro.data.pipeline as jpipe
    import repro_torch.data.pipeline as tpipe
    from repro.launch.soak import SoakWorld as JWorld
    from repro_torch.launch.soak import SoakWorld as TWorld
    return {"ref": (inspect.getsource(jpipe),
                    inspect.getsource(JWorld._probe_batch), jdet),
            "port": (inspect.getsource(tpipe),
                     inspect.getsource(TWorld._probe_batch), det)}


SEED = "(cfg.seed, step, self.host_id, 0xDA7A)"
PROBE = "        batch = dict(self.lm.global_batch_at(step))"
MUTANTS = {
    "wall-clock": ("probe", PROBE, "        batch = dict(self.lm."
                   "global_batch_at(step + int(time.time()) % 2))",
                   "forbidden-call"),
    "global-draw": ("pipeline", SEED, "(cfg.seed, step, self.host_id, "
                    "int(np.random.randint(9)))", "forbidden-call"),
    "self-write": ("probe", "        return batch",
                   "        self.last_step = step\n        return batch",
                   "iterator-state"),
    "seed-drift": ("pipeline", SEED, "(cfg.seed, self.host_id, 0xDA7A)",
                   REFERENCE_CODES["seed_drift"]),
}


def test_determinism_clean_on_own_sources():
    assert jdet.analyze().ok
    rep = det.analyze()
    assert rep.ok, rep.summary()
    assert [t.name for t in rep.targets] == \
        ["data/pipeline.py", "launch/soak.py::SoakWorld._probe_batch"]


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_determinism_mutant_codes_match(name):
    where, old, new, code = MUTANTS[name]
    for pkg, (pipe, probe, mod) in _sources().items():
        src = pipe if where == "pipeline" else probe
        assert old in src, pkg
        got = {f.code for f in mod.check_source(src.replace(old, new), where)}
        assert code in got, (pkg, got)


@pytest.mark.parametrize("src", [
    "def f(step):\n    return np.random.default_rng((time.time(), step))",
    "def f(step):\n    return np.random.randint(0, 9)",
    "def f(step):\n    return random.random()",
    "def f(step):\n    rng = np.random.default_rng()\n"
    "    return rng.integers(step)",
    "def f(step):\n    return np.random.default_rng((hash('s'), step))",
    "class S:\n    def batch_at(self, step):\n        self.cursor = step\n"
    "        return np.random.default_rng((self.cursor, step))",
    "def f(step):\n    global cur\n    cur += 1\n    return cur",
    "class S:\n    def __init__(self, seed):\n        self.seed = seed\n"
    "    def batch_at(self, step):\n"
    "        rng = np.random.default_rng((self.seed, step))\n"
    "        return rng.integers(0, 9, size=(4,))\n",
], ids=["wall-clock", "legacy-np", "stdlib-random", "unseeded", "hash-seed",
        "iter-state", "global", "seeded-clean"])
def test_determinism_rules_agree_with_reference(src):
    assert {f.code for f in det.check_source(src, "s")} == \
        {f.code for f in jdet.check_source(src, "s")}


@pytest.mark.parametrize("src,code", [
    ("def f(step):\n    return torch.randn(4)", "forbidden-call"),
    ("def f(step):\n    return torch.randint(0, 9, (4,))", "forbidden-call"),
    ("def f(step, x):\n    return x.normal_()", "forbidden-call"),
    ("def f(step):\n    torch.manual_seed(step)\n    return 0",
     "global-seed"),
    ("def f(step, seed):\n    g = torch.Generator()\n"
     "    return g.manual_seed(seed)", "seed-ignores-step"),
], ids=["randn", "randint", "normal_", "manual_seed", "gen-seed"])
def test_determinism_torch_global_rng(src, code):
    assert code in {f.code for f in det.check_source(src, "s")}


def test_determinism_torch_seeded_draws_are_clean():
    src = ("def f(step, seed):\n"
           "    g = torch.Generator().manual_seed(fold_seed(seed, step))\n"
           "    return torch.randn(4, generator=g)\n")
    assert not det.check_source(src, "s")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_json_single_arch(capsys):
    assert lint_main(["--arch", "llama3.2-1b", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 0 and out["findings"] == []
    assert set(out["seconds"]) == {"llama3.2-1b"}


def test_cli_and_verify_refuse_what_the_port_lacks():
    _, _, loss_fn, params, batch = lint_config("llama3.2-1b")
    with pytest.raises(ValueError, match="no meaning in the port"):
        verify(loss_fn, params, batch, backend="tpu")


def test_cli_cost_runs_the_gate_and_writes_a_report(tmp_path, capsys):
    """``--cost`` (once refused) runs the traffic and cost passes and the
    gate against the port's committed baseline, and writes the reports."""
    path = tmp_path / "cost.json"
    assert lint_main(["--arch", "llama3.2-1b", "--fast", "--cost",
                      "--cost-report", str(path), "--fail-on-error"]) == 0
    out = json.loads(path.read_text())
    assert out["profile"] == "h100-sxm-80gb"
    assert {(r["granularity"], r["n_streams"] == r["expected_streams"])
            for r in out["reports"]} == {("example", True), ("token", True)}
    assert len(out["reports"]) == 4
    assert "0 regression(s)" in capsys.readouterr().out
