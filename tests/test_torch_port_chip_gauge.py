"""The decision rule of chip_smoke.py's second-order term check (phase 11c's
float64 gauge, chip_smoke.gauge_verdict) on synthetic readings, on CPU.

Each reading is one try of term_vs_plain with the gauge: the kernels' and
the plain op's fp32 second-order terms, each as its relative distance from
the plain op's float64 term, and the kernels' relative distance from the
plain fp32 term. The rule fails a try only on the kernels' own distance
from float64, so an ill-conditioned draw, where both fp32 terms sit far
from float64, can no longer fail the run, while a wrong kernel still does.

Phase 16's per-call rule (chip_smoke.f64_held) on synthetic rows: a bf16
call past its bound against the plain version holds only while the kernel
is no farther from a float64 evaluation than the plain version plus that
bound.
"""

import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (imports torch and the port; no card needed)


def _r(plain, kernel, rel):
    return dict(plain_vs_f64=plain, kernel_vs_f64=kernel, rel_diff=rel)


# (readings, index of the held try or None, failures expected)
CASES = {
    # The kernels as far from float64 as the plain op on badly conditioned
    # draws (a run the old rule failed): nothing held, nothing fails.
    "all-ill-conditioned": ([_r(0.4, 0.41, 0.7), _r(2e-2, 2.2e-2, 3e-2), _r(0.9, 0.8, 1.2)],
                            None, 0),
    "held-on-the-second-try": ([_r(0.3, 0.31, 0.5), _r(2e-4, 2.5e-4, 3e-4)], 1, 0),
    # A wrong kernel: far from float64 where the plain term is near it.
    "wrong-kernel-well-conditioned": ([_r(1e-4, 0.5, 0.5)], 0, 2),
    # ... and on an ill-conditioned try, beyond the factor.
    "wrong-kernel-ill-conditioned": ([_r(0.1, 0.9, 0.8)], None, 1),
    # Within the floor on a well-conditioned try, but off the plain term.
    "off-plain-well-conditioned": ([_r(5e-4, 1e-3, 2e-2)], 0, 1),
    "nan-kernel": ([_r(0.2, math.nan, math.nan)], None, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gauge_verdict(name):
    readings, held, n_bad = CASES[name]
    got_held, bad = chip_smoke.gauge_verdict(readings)
    assert got_held is (None if held is None else readings[held])
    assert len(bad) == n_bad, bad


def _row(err, kernel, plain, tol=2.0 ** -8, scale=2.0):
    """A checked_calls row with the float64 gauge: error against the plain
    version and bound in absolute terms, distances from float64 relative
    to the plain result's largest value (`scale`)."""
    return dict(max_abs_err=err * scale, tol=tol * scale, scale=scale,
                kernel_vs_f64=kernel, plain_vs_f64=plain)


# (row, held) for phase 16's per-call rule, chip_smoke.f64_held.
F64_CASES = {
    "within-the-bound": (_row(0.9 * 2.0 ** -8, 0.5, 1e-3), True),
    # One bf16 step apart at the largest value, both as near float64.
    "one-bf16-step-apart": (_row(2.0 ** -7, 3.1e-3, 3.0e-3), True),
    "past-the-bound-as-far-as-plain-plus-the-bound": (_row(2.0 ** -7, 3.0e-3 + 2.0 ** -8,
                                                           3.0e-3), True),
    # A wrong kernel: off the plain version and away from float64.
    "wrong-kernel": (_row(0.05, 0.05, 3.0e-3), False),
    "nan-kernel": (_row(math.nan, math.nan, 3.0e-3), False),
}


@pytest.mark.parametrize("name", sorted(F64_CASES))
def test_f64_held(name):
    row, held = F64_CASES[name]
    assert chip_smoke.f64_held(row) is held
