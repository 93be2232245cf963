"""The CUDA DCN kernels (K1 dcn_fwd, K2 dcn_bwd_data, K3 dcn_bwd_weight)
against the plain PyTorch version, on the card.

Every test here is gpu-marked and skips without a card. This file imports no JAX, so on
the card it runs without the repository's conftest:

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest

Tolerances: fp32 — the kernels and dcn_ref do the same fp32 arithmetic in
another order (atomics in K2/K3 change it from run to run), so 1e-4 of the
largest reference value (TF32 off). bf16 — both sides read the same bf16
inputs; the reference runs in fp32 on them and the kernels round their
fp32 results to bf16 once, so 2^-7 of the largest reference value.
"""

import pytest
import torch

from dynavsr_tpu_torch.ops import dcn
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, c, cout, h, w, gd, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    offset = torch.randn(b, 2 * gd * 9, h, w, generator=g) * 2.0 + 0.37
    mask = torch.rand(b, gd * 9, h, w, generator=g)
    weight = torch.randn(cout, c, 3, 3, generator=g) * (1.0 / (c * 9) ** 0.5)
    bias = torch.randn(cout, generator=g)
    cot = torch.randn(b, cout, h, w, generator=g)
    return [t.to(device) for t in (x, offset, mask, weight, bias, cot)]


def _close(got, ref, tol):
    ref = ref.detach().float()
    err = float((got.float() - ref).abs().max())
    bound = tol * max(float(ref.abs().max()), 1e-6)
    assert err <= bound, f"max |err| {err:.3e} > {bound:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 64, 13, 21), (3, 8, 6, 9, 7), (1, 128, 64, 11, 70)],
                         ids=["c64", "c8", "c128"])
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_kernels_match_plain(cuda, shape, gd, dtype, with_mask):
    b, c, cout, h, w = shape
    x, offset, mask, weight, bias, cot = _inputs(b, c, cout, h, w, gd, cuda, seed=gd)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    lo = [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]
    x, offset, mask, weight, bias, cot = lo
    m = mask if with_mask else None

    # Plain version in fp32 on the (possibly bf16-rounded) inputs.
    ref_in = [t.float().requires_grad_() for t in (x, offset, mask, weight, bias)]
    ref = deform_conv2d_ref(ref_in[0], ref_in[1], ref_in[2] if with_mask else None,
                            ref_in[3], ref_in[4], deformable_groups=gd)
    ref.backward(cot.float())

    out = dcn.dcn_fwd(x, offset, m, weight, bias, gd)
    gx, goff, gmask = dcn.dcn_bwd_data(x, offset, m, weight, cot, gd)
    gw = dcn.dcn_bwd_weight(x, offset, m, cot, gd)
    torch.cuda.synchronize()
    assert out.dtype == gx.dtype == goff.dtype == gw.dtype == dtype
    _close(out, ref, tol)
    _close(gx, ref_in[0].grad, tol)
    _close(goff, ref_in[1].grad, tol)
    if with_mask:
        _close(gmask, ref_in[2].grad, tol)
    else:
        assert gmask is None
    _close(gw, ref_in[3].grad, tol)


@pytest.mark.gpu
def test_autograd_goes_through_the_kernels(cuda):
    x, offset, mask, weight, bias, cot = _inputs(2, 16, 16, 8, 12, 2, cuda, seed=0)
    params = [t.requires_grad_() for t in (x, offset, mask, weight, bias)]
    dcn.reset_launch_counts()
    out = dcn.deform_conv2d(*params, deformable_groups=2)
    out.backward(cot)
    assert dcn.launch_counts() == {"dcn_fwd": 1, "dcn_bwd_data": 1, "dcn_bwd_weight": 1}
    ref_in = [t.detach().clone().requires_grad_() for t in params]
    deform_conv2d_ref(*ref_in, deformable_groups=2).backward(cot)
    for got, want in zip(params, ref_in):
        _close(got.grad, want.grad, 1e-4)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, offset, mask, weight, bias, _ = _inputs(1, 16, 16, 8, 8, 2, cuda, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        dcn.dcn_fwd(x.transpose(2, 3), offset, mask, weight, bias, 2)
    with pytest.raises(ValueError, match="dtype"):
        dcn.dcn_fwd(x.double(), offset, mask, weight, bias, 2)
    with pytest.raises(ValueError, match="offset"):
        dcn.dcn_fwd(x, offset[:, :9], mask, weight, bias, 2)
    with pytest.raises(ValueError, match="must be on"):
        dcn.dcn_fwd(x, offset.cpu(), mask, weight, bias, 2)
