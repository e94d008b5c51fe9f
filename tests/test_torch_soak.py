"""The port's elastic soak harness, end to end on the CPU.

One spawned group of 4 gloo ranks (one per simulated host) runs the
``short`` storm for 24 steps and then the mutation check, so the ranks
start once. The storm must pass all three invariants (bit-exact restore,
data replay, norm invariance) and cover what the storm is for: two
contractions, an expansion, a restore that falls back past the corrupted
step, and a quarantine that names exactly the poisoned row. Its
recoveries are the reference's (``python -m repro.launch.soak --hosts 4
--steps 24`` reports the same ticks, reasons, restored steps and host
sets). Each of the three mutants trips its own invariant.
"""
from repro_torch import ft
from repro_torch.launch import soak


def test_soak_short_storm_and_mutation_check():
    out = soak.run_group(
        soak.SoakConfig(hosts=4, steps=24, seed=0, verbose=False,
                        device="cpu"), ("storm", "mutants"))
    assert out["error"] is None, out["error"]
    summary = out["summary"]
    assert summary["invariants"] == "PASS"
    assert summary["contractions"] >= 2
    assert summary["expansions"] >= 1
    assert summary["fallbacks"] >= 1          # corrupt ckpt → fell back
    poisoned = {i for e in ft.scripted_storm("short", 4, 24).events
                if e.kind == "nan_batch" for i in e.examples}
    assert summary["quarantined_steps"] == [14]
    assert summary["quarantined_examples"] == sorted(poisoned)
    assert summary["ticks"] == 30 and summary["final_hosts"] == 2
    assert [(r["reason"], r["restored_step"], r["hosts"])
            for r in summary["recoveries"]] == [
        ("contract", 6, [0, 1]), ("contract", 6, [1]), ("expand", 12, [0, 1])]
    assert out["mutation_check"] == {"restore": "bit-exact-restore",
                                     "renumber": "data-replay",
                                     "reshard": "norm-invariance"}
