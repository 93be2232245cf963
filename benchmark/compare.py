"""The numbers the correctness check compares, each a gap between the
program's answer and the plain reference's (benchmark/reference/)."""

from __future__ import annotations

from typing import Dict, List

import torch


def max_abs(prog: Dict, ref: Dict) -> float:
    """Largest |program - reference| over the keyed arrays (SR frames)."""
    return max(float((torch.as_tensor(prog[k]).float().to(ref[k].device) - ref[k].float())
                     .abs().max()) for k in ref)


def rel_gap(prog: List[float], ref: List[float]) -> float:
    """Largest |program - reference| / |reference| over a sequence (losses);
    1 where the lengths differ."""
    if len(prog) != len(ref) or not ref:
        return 1.0
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Per leaf, |‖program leaf‖ - ‖reference leaf‖| over the larger of the
    reference leaf's norm and the median leaf's (some leaves are all but
    zero). `keep`, a set of names, leaves the others out."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].float().norm()) for k in names}
    med = float(torch.tensor(list(rn.values())).median()) if names else 0.0
    return {k: abs(float(prog[k].float().norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in names}


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep=None) -> float:
    """The worst leaf of leaf_gaps."""
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def change_numbers(prog_after, ref_after, p0, first_grads) -> Dict[str, float]:
    """The leaves' change over the steps, program against reference: the
    worst leaf's gap, the median leaf's, and the three worst leaves
    (name, gap, size) for the record."""
    gaps = leaf_gaps(moved(prog_after, p0), moved(ref_after, p0), live_leaves(first_grads))
    vals = sorted(gaps.values())
    worst = sorted(gaps, key=gaps.get)[-3:][::-1]
    return {"weight_change_gap": vals[-1] if vals else 0.0,
            "weight_change_median": vals[len(vals) // 2] if vals else 0.0,
            "_worst": [(k, gaps[k], p0[k].numel()) for k in worst]}


def moved(adapted: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]) -> Dict:
    """Each leaf's change: adapted - start."""
    return {k: adapted[k].float().to(start[k].device) - start[k].float() for k in start}


def live_leaves(first_grads: Dict[str, torch.Tensor], floor: float = 1e-3) -> set:
    """Leaves whose first reference gradient is above `floor` of the median
    leaf's norm: under Adam a leaf with a gradient nought to rounding moves
    by round-off alone, so its change is left out of the comparison."""
    norms = {k: float(g.float().norm()) for k, g in first_grads.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return {k for k, n in norms.items() if n > floor * med}
