"""The decision rule of chip_smoke.py's second-order term check (phase 11c's
float64 gauge, chip_smoke.gauge_verdict) on synthetic readings, on CPU.

Each reading is one try of term_vs_plain with the gauge: the kernels' and
the plain op's fp32 second-order terms, each as its relative distance from
the plain op's float64 term, and the kernels' relative distance from the
plain fp32 term. The rule fails a try only on the kernels' own distance
from float64, so an ill-conditioned draw, where both fp32 terms sit far
from float64, can no longer fail the run, while a wrong kernel still does.

Each try reads the plain op's distance from float64 twice (the batch, and
the batch moved by about one fp32 ulp); the larger is the yardstick, so a
single plain draw that lands near float64 by chance does not make an
ill-conditioned try count as well-conditioned.

The term checks run with the meta loss's Charbonnier eps at
chip_smoke.TERM_CB_EPS (chip_smoke.meta_charbonnier): at the configs'
1e-12 the exact term jumps where a residual sits near zero, so no fp32
evaluation can be held to float64. A small TOFlow on the CPU shows the
premise at TERM_CB_EPS: fp32 and float64 terms within GAUGE, and the
float64 term steady under a one-ulp move of the batch.

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
from torch_one_thread import one_thread  # noqa: E402, F401


def _r(plain, kernel, rel, jitter=None):
    r = dict(plain_vs_f64=plain, kernel_vs_f64=kernel, rel_diff=rel)
    if jitter is not None:  # the plain op's second fp32 draw (the batch moved by an ulp)
        r["plain_jitter_vs_f64"] = jitter
    return r


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
    # One plain draw lands near float64 by chance while its second draw and
    # the kernels' sit where an ill-conditioned term puts fp32 (DUF's 11c on
    # the card): nothing held, nothing fails.
    "lucky-plain-draw": ([_r(6.6e-3, 6.6e-3, 5.4e-5, 7e-3),
                          _r(2.6e-4, 1.13e-2, 1.12e-2, 1.5e-2)], None, 0),
    # A wrong kernel where both plain draws lie near float64: held, fails.
    "wrong-kernel-both-draws-near": ([_r(1e-4, 5e-2, 5e-2, 2e-4)], 0, 2),
    # ... and beyond the factor of the farther draw.
    "wrong-kernel-past-the-farther-draw": ([_r(2.6e-4, 0.2, 0.2, 1.5e-2)], None, 1),
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


# (flow (dx, dy) over a 4x5 frame, share of samples off the frame): a
# sample at x + dx, y + dy is on the frame while 0 <= x + dx <= W - 1 and
# 0 <= y + dy <= H - 1, the warp's border pixels included.
OFF_FRAME = {
    "still": ((0.0, 0.0), 0.0),
    "one-column-right": ((1.0, 0.0), 4 / 20),
    "half-a-pixel-up": ((0.0, -0.5), 5 / 20),
    "diagonal": ((-1.0, 1.0), 8 / 20),
    "far-away": ((40.0, -7.0), 1.0),
}


@pytest.mark.parametrize("name", list(OFF_FRAME))
def test_off_frame_share(name):
    """chip_smoke.off_frame_share, phase 16's reading of how many of a
    trained flow's samples land in the warp's zero padding."""
    import torch

    (dx, dy), want = OFF_FRAME[name]
    flow = torch.stack([torch.full((4, 5), dx), torch.full((4, 5), dy)])[None]
    assert chip_smoke.off_frame_share(flow) == pytest.approx(want)


@pytest.mark.parametrize("eps", [chip_smoke.TERM_CB_EPS, 1e-12])
def test_meta_charbonnier_sets_and_restores_eps(eps):
    """chip_smoke.meta_charbonnier, the loss of 11c's and 15's term checks:
    train/meta.py's Charbonnier takes `eps` inside the block, the configs'
    1e-12 again after it."""
    import torch

    from dynavsr_tpu_torch.train import losses
    from dynavsr_tpu_torch.train import meta as meta_module

    pred, target = torch.tensor([0.5, 0.25]), torch.tensor([0.5, 0.0])
    with chip_smoke.meta_charbonnier(eps):
        got = meta_module.charbonnier_loss(pred, target)
    want = torch.sqrt(torch.tensor([0.0, 0.0625]) + eps).sum()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert meta_module.charbonnier_loss is losses.charbonnier_loss


def test_tof_meta_term_is_conditioned_at_the_checks_eps():
    """The premise of 11c's float64 gauge at chip_smoke.TERM_CB_EPS: on a
    small TOFlow (LR 8, SpyNet biases redrawn as 11c redraws them) the
    fp32 second-order meta term lies within GAUGE of the float64 one on the
    batch and on the batch moved by one ulp, and the float64 term itself
    moves less than GAUGE with that move (tools/meta_term_conditioning.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "meta_term_conditioning", os.path.join(ROOT, "tools", "meta_term_conditioning.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    (r,) = tool.probe(draws=1, lr=8, eps=(chip_smoke.TERM_CB_EPS,))
    assert r["share"] >= chip_smoke.TERM_SHARE, r
    for key in ("fp32", "fp32_moved", "f64_moved"):
        assert r[key] <= chip_smoke.GAUGE, r
