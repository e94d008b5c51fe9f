"""The comparison that decides ``correct``: the program's readings of the
steps the reference follows against the reference's, each number against
its limit from ``perfbench/limits/<cell>.json``.

- ``loss_gap``: the largest |loss_p − loss_r| / |loss_r| over the steps.
- ``norm_gap`` (cells whose traffic asks for the norms): the largest
  |‖g_j‖_p − ‖g_j‖_r| / ‖g_j‖_r over the steps and examples.
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient as the optimizer takes it,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger.
- ``clean_gap`` (cells that add noise): the same for the first gradient
  before the noise, the clipped sum of the reweighted backward. The noise
  (σ·C per coordinate) outweighs that sum by orders of magnitude in each
  leaf, so ``grad_gap`` cannot see a wrong clip factor or a wrong second
  pass; this number does.
- ``update_gap``: the same for the parameters' change over the steps.
- ``route_gap`` (MoE cells): the reference's own reading, over tokens,
  of how much less probability the experts chosen in the program's place
  carry than the reference's top k, which it follows in their stead.

The leaves counted: those whose first gradient in the reference (before
any noise) is at least a thousandth of the median leaf's. A leaf under
that (a key bias under softmax) moves by round-off alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the leaf gaps
LEAF_FLOOR = 1e-3


def counted_leaves(grad_clean: List[float]) -> List[int]:
    med = statistics.median(grad_clean)
    return [i for i, g in enumerate(grad_clean) if g >= LEAF_FLOOR * med]


def leaf_gap(prog: List[float], ref: List[float], keep: List[int]) -> float:
    if len(prog) != len(ref):
        return math.inf
    med = statistics.median(ref[i] for i in keep)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep)


def _rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if r else math.inf


def numbers(prog: Dict, ref: Dict, norms: bool,
            noised: bool = False) -> Dict[str, float]:
    """The compared numbers; a missing or misshapen reading is inf."""
    out = {}
    if len(prog["loss"]) != len(ref["loss"]):
        out["loss_gap"] = math.inf
    else:
        out["loss_gap"] = max(_rel(p, r) for p, r in zip(prog["loss"],
                                                        ref["loss"]))
    if norms:
        gap = 0.0
        for sp, sr in zip(prog["sq_norms"], ref["sq_norms"]):
            if len(sp) != len(sr):
                gap = math.inf
                break
            gap = max([gap] + [_rel(math.sqrt(max(p, 0.0)), math.sqrt(r))
                               for p, r in zip(sp, sr)])
        if len(prog["sq_norms"]) != len(ref["sq_norms"]):
            gap = math.inf
        out["norm_gap"] = gap
    keep = counted_leaves(ref["grad_clean"])
    out["grad_gap"] = leaf_gap(prog["grad_seen"], ref["grad_seen"], keep)
    if noised:
        out["clean_gap"] = leaf_gap(prog.get("grad_clean", []),
                                    ref["grad_clean"], keep)
    out["update_gap"] = leaf_gap(prog["update"], ref["update"], keep)
    if ref.get("routes") and ref["routes"][0]:
        out["route_gap"] = ref["route_gap"]
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def decide(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number at or under its limit, a NaN or a
    number with no limit failing; checks maps each name to its value and
    limit."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in nums.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
