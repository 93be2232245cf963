"""The port's degradation synthesis (data/degradations.py) against the JAX
package's, on CPU: the same numpy inputs and kernel parameters through both.

The two draw their random kernels from different generators (torch's vs
JAX's PRNG), so a draw is held by feeding what the port drew to JAX's
functions. Tolerances: kernels 1e-6 absolute (fp32 exp and a sum of 169
terms, entries <= 1); blurs 1e-5 absolute (fp32 sums of 169 products of
values in [0, 1]); the MATLAB-bicubic downsample 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.data import degradations as jax_deg
from dynavsr_tpu_torch.data import degradations as deg


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("size", [13, 21])
@pytest.mark.parametrize("sigma", [0.2, 1.3, 4.0])
def test_isotropic_kernel_matches_jax(size, sigma):
    _close(deg.isotropic_kernel(size, sigma), jax_deg.isotropic_kernel(size, sigma), 1e-6)


@pytest.mark.parametrize("sx,sy,theta", [(0.5, 3.0, 0.0), (2.2, 0.7, 1.1), (4.0, 4.0, 2.9),
                                         (1.0, 0.2, np.pi / 2)])
def test_anisotropic_kernel_matches_jax(sx, sy, theta):
    _close(deg.anisotropic_kernel(13, sx, sy, theta),
           jax_deg.anisotropic_kernel(13, sx, sy, theta), 1e-6)


def test_random_kernel_batch_draws_normalised_kernels_in_range_reproducibly():
    """The parameters lie in their ranges, both kinds are drawn, the kernels
    sum to 1 and equal JAX's isotropic / anisotropic kernels of the same
    parameters, and one seed gives one batch."""
    batch = 64
    p = deg.random_kernel_params(torch.Generator().manual_seed(3), batch, (0.2, 4.0), 0.5)
    k = deg.random_kernel_batch(torch.Generator().manual_seed(3), batch)
    assert k.shape == (batch, 13, 13)
    assert ((p["sigma_iso"] >= 0.2) & (p["sigma_iso"] <= 4.0)).all()
    assert ((p["sigma_xy"] >= 0.2) & (p["sigma_xy"] <= 4.0)).all()
    assert ((p["theta"] >= 0) & (p["theta"] <= np.pi)).all()
    assert 0 < int(p["aniso"].sum()) < batch
    torch.testing.assert_close(k.sum((1, 2)), torch.ones(batch), rtol=0, atol=1e-6)
    for i in range(batch):
        if p["aniso"][i]:
            want = jax_deg.anisotropic_kernel(13, float(p["sigma_xy"][i, 0]),
                                              float(p["sigma_xy"][i, 1]), float(p["theta"][i]))
        else:
            want = jax_deg.isotropic_kernel(13, float(p["sigma_iso"][i]))
        _close(k[i], want, 1e-6)
    assert torch.equal(k, deg.random_kernel_batch(torch.Generator().manual_seed(3), batch))
    assert not torch.equal(k, deg.random_kernel_batch(torch.Generator().manual_seed(4), batch))
    assert not deg.random_kernel_params(torch.Generator().manual_seed(3), batch,
                                        aniso_prob=0.0)["aniso"].any()


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _kernels(b, seed):
    return deg.random_kernel_batch(torch.Generator().manual_seed(seed), b).numpy()


@pytest.mark.parametrize("video", [False, True], ids=["images", "video"])
@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per-sample"])
@pytest.mark.parametrize("scale", [2, 4])
def test_blur_downsample_matches_jax(video, per_sample, scale):
    x = _images((3, 4, 24, 20, 3) if video else (3, 24, 20, 3), seed=1)
    k = _kernels(3, seed=2) if per_sample else _kernels(1, seed=2)[0]
    got = deg.blur_downsample(torch.from_numpy(x), torch.from_numpy(k), scale)
    want = jax_deg.blur_downsample(jnp.asarray(x), jnp.asarray(k), scale)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_bicubic_downsample_matches_jax():
    x = _images((2, 32, 24, 3), seed=5)
    _close(deg.bicubic_downsample(torch.from_numpy(x), 4),
           jax_deg.bicubic_downsample(jnp.asarray(x), 4), 1e-5)


def test_synthesize_pair_is_jax_blur_downsample_of_its_kernels():
    """The kernels the port drew, fed to JAX's blur_downsample, give the
    port's LR from HR and SLR from LR; one generator state, one pair."""
    hr = _images((3, 5, 32, 40, 3), seed=7)
    lr, slr, k = deg.synthesize_pair(torch.Generator().manual_seed(9), torch.from_numpy(hr), 4)
    kj = jnp.asarray(k.numpy())
    assert lr.shape == (3, 5, 8, 10, 3) and slr.shape == (3, 5, 2, 3, 3)
    _close(lr, jax_deg.blur_downsample(jnp.asarray(hr), kj, 4), 1e-5)
    _close(slr, jax_deg.blur_downsample(jnp.asarray(lr.numpy()), kj, 4), 1e-5)
    again = deg.synthesize_pair(torch.Generator().manual_seed(9), torch.from_numpy(hr), 4)
    assert all(torch.equal(a, b) for a, b in zip((lr, slr, k), again))


def test_synthesize_pair_noise_leg():
    """With noise_range the kernels are the noise-free draw's, LR is
    noisy and clipped to [0, 1], and SLR is the blur-down of the noisy LR
    (in the port and in JAX's blur_downsample alike)."""
    hr = _images((2, 3, 32, 32, 3), seed=11)
    clean = deg.synthesize_pair(torch.Generator().manual_seed(1), torch.from_numpy(hr), 4)
    lr, slr, k = deg.synthesize_pair(torch.Generator().manual_seed(1), torch.from_numpy(hr), 4,
                                     noise_range=(0.05, 0.1))
    assert torch.equal(k, clean[2])
    assert float(lr.min()) >= 0.0 and float(lr.max()) <= 1.0
    assert float((lr - clean[0]).abs().max()) > 0.01
    torch.testing.assert_close(slr, deg.blur_downsample(lr, k, 4), rtol=0, atol=0)
    _close(slr, jax_deg.blur_downsample(jnp.asarray(lr.numpy()), jnp.asarray(k.numpy()), 4),
           1e-5)


def test_duf_downsample_still_matches_jax():
    x = _images((2, 36, 44, 3), seed=13)
    _close(deg.duf_downsample(torch.from_numpy(x), 4),
           jax_deg.duf_downsample(jnp.asarray(x), 4), 1e-5)
