"""The port's small modules against the JAX package's, on CPU.

Same numpy inputs (and, for modules with weights, the same JAX-initialised
params carried over by convert/from_jax.py) through both frameworks; JAX
is NHWC, the port NCHW inside, so the tests transpose at the boundary.
Tolerances are stated per test: fp32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.data.resize import imresize as jax_imresize
from dynavsr_tpu.data.windows import all_windows as jax_all_windows
from dynavsr_tpu.models import arch_util as jau
from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
from dynavsr_tpu.models.padding import mod_pad_apply as jax_mod_pad_apply
from dynavsr_tpu.ops.pixelshuffle import pixel_shuffle as jax_pixel_shuffle
from dynavsr_tpu.train.losses import charbonnier_loss as jax_charbonnier
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.models import arch_util as tau
from dynavsr_tpu_torch.models.downscaler import MFDN
from dynavsr_tpu_torch.models.padding import mod_pad_apply
from dynavsr_tpu_torch.ops.pixelshuffle import pixel_shuffle
from dynavsr_tpu_torch.train.losses import charbonnier_loss


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(model, params):
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params), model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def test_interpolate_bilinear_matches_jax():
    """align_corners=False half-pixel resize; 2e-6 (fp32 rounding)."""
    x = np.random.default_rng(0).random((2, 7, 9, 5)).astype(np.float32)
    for scale in (2, 4):
        ours = _nhwc(tau.interpolate_bilinear(_nchw(x), scale))
        ref = np.asarray(jau.interpolate_bilinear(jnp.asarray(x), scale))
        np.testing.assert_allclose(ours, ref, atol=2e-6)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pools_match_jax(pool):
    """3x3 stride-2 pad-1 pools (avg counts the padding); 1e-6."""
    x = np.random.default_rng(1).standard_normal((2, 9, 12, 4)).astype(np.float32)
    ours = getattr(tau, f"{pool}_pool_3x3_s2")(_nchw(x))
    ref = getattr(jau, f"{pool}_pool_3x3_s2")(jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), atol=1e-6)


def test_res_trunk_matches_jax():
    """Scan-stacked JAX trunk params -> indexed torch keys; 1e-5."""
    x = np.random.default_rng(2).standard_normal((2, 6, 7, 8)).astype(np.float32)
    jm = jau.ResTrunk(nf=8, n_blocks=3)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(tau.ResTrunk(nf=8, n_blocks=3), params)
    assert "2.conv2.weight" in tm.state_dict()
    with torch.no_grad():
        ours = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(ours, np.asarray(jm.apply(params, jnp.asarray(x))), atol=1e-5)


def test_lrelu_slope():
    x = torch.tensor([-2.0, -0.5, 0.0, 1.5])
    np.testing.assert_allclose(tau.lrelu(x).numpy(),
                               np.asarray(jau.lrelu(jnp.asarray(x.numpy()))))


def test_pixel_shuffle_matches_jax():
    """Exact: a permutation."""
    x = np.random.default_rng(3).random((2, 5, 6, 12)).astype(np.float32)
    ours = _nhwc(pixel_shuffle(_nchw(x), 2))
    np.testing.assert_array_equal(ours, np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("scale", [0.25, 4.0])
def test_imresize_matches_jax(scale):
    """Two fp32 matmuls at full precision on both sides; 1e-5."""
    x = np.random.default_rng(4).random((2, 3, 17, 23, 3)).astype(np.float32)
    ours = imresize(torch.from_numpy(x), scale).numpy()
    ref = np.asarray(jax_imresize(jnp.asarray(x), scale))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_mfdn_matches_jax():
    """MFDN at nf 8, 3 frames, 16x20 LR -> 4x5 SLR; 1e-5."""
    x = np.random.default_rng(5).random((2, 3, 16, 20, 3)).astype(np.float32)
    jm = JaxMFDN(scale=4, nf=8)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(MFDN(scale=4, nf=8, nframes=3), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 3, 4, 5, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_charbonnier_matches_jax(reduction):
    """eps 1e-12; 1e-6 relative."""
    rng = np.random.default_rng(6)
    a, b = (rng.random((3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    ours = float(charbonnier_loss(torch.from_numpy(a), torch.from_numpy(b),
                                  reduction=reduction))
    ref = float(jax_charbonnier(jnp.asarray(a), jnp.asarray(b), reduction=reduction))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


@pytest.mark.parametrize("hw", [(9, 11), (30, 45)])
def test_mod_pad_apply_matches_jax(hw):
    """Reflect-pad bottom/right to a multiple of 4, apply (here a x2
    nearest upsample plus a position-dependent ramp), crop; exact."""
    h, w = hw
    x = np.random.default_rng(7).random((2, 3, h, w, 3)).astype(np.float32)

    def jax_apply(v):
        up = jnp.repeat(jnp.repeat(v, 2, axis=-3), 2, axis=-2)
        return up + jnp.arange(up.shape[-2], dtype=jnp.float32)[:, None]

    def torch_apply(v):
        up = v.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return up + torch.arange(up.shape[-2], dtype=torch.float32)[:, None]

    ours = mod_pad_apply(torch_apply, torch.from_numpy(x), mod=4, scale=2).numpy()
    ref = np.asarray(jax_mod_pad_apply(jax_apply, jnp.asarray(x), mod=4, scale=2))
    assert ours.shape == ref.shape == (2, 3, 2 * h, 2 * w, 3)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("padding", ["replicate", "reflection", "reflection_circle",
                                     "circle", "new_info"])
def test_all_windows_matches_jax(padding):
    for t, n in ((16, 5), (7, 3), (3, 5)):
        np.testing.assert_array_equal(all_windows(t, n, padding),
                                      jax_all_windows(t, n, padding))
