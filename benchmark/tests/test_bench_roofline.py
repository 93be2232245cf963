"""The yardstick's arithmetic on hand-checked shapes (CPU only)."""

import pytest
import torch

from benchmark import roofline
from benchmark.reference import nets
from benchmark.trace import Event, Trace, union_us


def test_k1_bounds_at_the_clip_shape():
    # 40 x 64 x 144 x 176, Gd 8: fp32 is bound by 2*B*HW*64*64*9 operations
    # at 67 TFLOP/s, bf16 by 697.5 MB at 3.35 TB/s (PERF.md's K1 row: 1.116
    # and 0.208 ms).
    px = 40 * 144 * 176
    assert roofline.dcn_bound("dcn_fwd", (40, 64, 144, 176), 8, torch.float32) == \
        pytest.approx(2 * px * 64 * 64 * 9 / 67e12)
    assert roofline.dcn_bound("dcn_fwd", (40, 64, 144, 176), 8, torch.float32) * 1e3 == \
        pytest.approx(1.116, abs=5e-4)
    nbytes = px * 2 * (64 + 144 + 72 + 64) + 64 * 64 * 9 * 2 + 64 * 2
    assert roofline.dcn_bound("dcn_fwd", (40, 64, 144, 176), 8, torch.bfloat16) == \
        pytest.approx(nbytes / 3.35e12)


def test_tangent_bound_counts_the_offset_cotangent_twice():
    b, c, h, w, gd = 40, 64, 16, 16, 8
    px, e = b * h * w, 2
    base = px * c * e + 2 * px * 2 * gd * 9 * e + px * gd * 9 * e
    got = roofline.tangent_bound("dcn_bwd_weight_tangent", (b, c, h, w), gd, torch.bfloat16)
    want = max((base + px * c * e + c * c * 9 * e) / 3.35e12, 2 * px * c * c * 9 / 989e12)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name,label", [
    ("void dcn_fwd_kernel<float, 8>(...)", "dcn_fwd"),
    ("dcn_fwd_tangent_kernel<__nv_bfloat16>", "dcn_fwd_tangent"),
    ("void fwd::to_channels_last<float>(...)", "dcn_fwd helpers"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32", "conv fprop"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("something unknown", "other")])
def test_kernel_labels(name, label):
    assert roofline.kernel_label(name) == label


def test_roofline_and_mfu_from_a_trace():
    tr = Trace(window_s=2.0, device=[Event("dcn_fwd_kernel", 0.0, 3000.0),
                                     Event("fwd::to_channels_last", 3000.0, 4000.0),
                                     Event("elementwise", 5000.0, 6000.0)])
    tr.dcn_calls = [("dcn_fwd", (40, 64, 144, 176), 8, torch.float32)] * 2
    bound = 2 * roofline.dcn_bound("dcn_fwd", (40, 64, 144, 176), 8, torch.float32)
    assert roofline.roofline_pct(tr, ("dcn_fwd",)) == pytest.approx(100 * bound / 4e-3)
    assert roofline.roofline_pct(tr, ("dcn_bwd_data",)) is None
    tr.info.update(dtype="fp32", flops_per_unit=67e12)
    tr.counters["units"] = 1
    assert roofline.mfu_pct(tr) == pytest.approx(50.0)
    assert union_us([Event("a", 0, 10), Event("b", 5, 20), Event("c", 30, 31)]) == 21


def test_lower_precisions_round_as_named():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0e-3])
    t = nets.rounding("tf32")(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -9
    f = nets.rounding("fp8")(x)  # one scale: the largest value maps to 448
    assert f[1] == pytest.approx(float(x[1]), rel=1e-6)
    assert ((f - x).abs() / x).max() <= 2 ** -4  # e4m3's 3-bit mantissa
    assert not torch.equal(f, x)
    assert torch.equal(nets.rounding("none")(x), x)
