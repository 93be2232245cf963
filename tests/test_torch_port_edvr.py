"""The port's EDVR against the JAX EDVR, on CPU, through
convert/from_jax.py:jax_params_to_state_dict.

Tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 residual blocks) on 16x20 frames.
All weights are redrawn at He scale (the DCNs' zero-initialised offset
convs included), so sampling is off the pixel grid and the network's output
is O(1). Tolerances: fp32 1e-4 absolute on SR values of O(1)
(many summation orders: convs, DCN, upsampling); bf16 stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.data.windows import all_windows
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.edvr import EDVR

CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
T, H, W = 5, 16, 20


@pytest.fixture(scope="module")
def params():
    """JAX-shaped params redrawn at He scale, so the network's output (not
    just the bilinear base) carries the comparison, and the offset convs
    sample off the pixel grid."""
    x = jnp.zeros((1, 3, H, W, 3))
    params = jax.jit(JaxEDVR(**CFG).init)(jax.random.PRNGKey(0), x)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)

    def perturb(tree, name=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, k)
            elif k in ("kernel", "weight"):  # He-normal: O(1) activations
                fan_in = np.prod(v.shape[-4:-1])
                gain = 0.3 if name == "conv_offset_mask" else (2.0 / fan_in) ** 0.5
                tree[k] = (rng.standard_normal(v.shape) * gain).astype(np.float32)
            else:
                tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)

    perturb(params["params"])
    return params


def _torch_model(params, dtype=None):
    model = EDVR(**CFG, dtype=dtype)
    model.load_state_dict(jax_params_to_state_dict(params, model.state_dict()), strict=True)
    return model.eval()


def _clip(seed=1):
    return np.random.default_rng(seed).random((T, H, W, 3)).astype(np.float32)


def test_forward_matches_jax(params):
    frames = _clip()
    win = all_windows(T, 3, "reflection")
    windows = frames[win]  # (T, 3, H, W, 3)
    ref = np.asarray(jax.jit(JaxEDVR(**CFG).apply)(params, jnp.asarray(windows)))
    with torch.no_grad():
        ours = _torch_model(params)(torch.from_numpy(windows)).numpy()
    assert ours.shape == ref.shape == (T, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_pyramid_halves_match_jax(params):
    frames = _clip(seed=3)
    jm = JaxEDVR(**CFG)
    jl = jax.jit(lambda p, f: jm.apply(p, f, method="extract_pyramid"))(
        params, jnp.asarray(frames))
    model = _torch_model(params)
    with torch.no_grad():
        tl = model.extract_pyramid(torch.from_numpy(frames))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1), np.asarray(b), atol=1e-5)
    win = all_windows(T, 3, "reflection")[:2]
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method="fuse_pyramid"))(
        params, *(f[win] for f in jl), jnp.asarray(frames[win[:, 1]]))
    with torch.no_grad():
        idx = torch.from_numpy(win).long()
        ours = model.fuse_pyramid(*(f[idx] for f in tl), torch.from_numpy(frames[win[:, 1]]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


def test_forward_seq_matches_jax_and_windows(params):
    frames = _clip(seed=5)
    win = all_windows(T, 3, "reflection")
    seq_fn = jax.jit(lambda p, f, w: JaxEDVR(**CFG).apply(p, f, w, method="forward_seq"))
    ref = np.asarray(seq_fn(params, jnp.asarray(frames), jnp.asarray(win)))
    model = _torch_model(params)
    with torch.no_grad():
        seq = model.forward_seq(torch.from_numpy(frames), torch.from_numpy(win).long()).numpy()
        batched = model(torch.from_numpy(frames[win])).numpy()
    np.testing.assert_allclose(seq, ref, atol=2e-4)
    np.testing.assert_allclose(seq, batched, atol=1e-5)


def test_bf16_forward_matches_jax_bf16(params):
    """bf16 convs and DCN with fp32 params, output fp32. bf16 offsets move
    sampling positions by up to a few hundredths of a pixel and the network
    amplifies that, so each framework's bf16 output departs from the fp32
    output by ~8% of the mean |SR| here. The test holds the port's bf16
    error (against the fp32 JAX output) to at most 1.5x JAX's own bf16
    error, in the mean and in the max."""
    windows = jnp.asarray(_clip(seed=7)[all_windows(T, 3, "reflection")])
    ref32 = np.asarray(jax.jit(JaxEDVR(**CFG).apply)(params, windows))
    ref16 = np.asarray(jax.jit(JaxEDVR(**CFG, dtype=jnp.bfloat16).apply)(params, windows))
    with torch.no_grad():
        ours = _torch_model(params, dtype=torch.bfloat16)(torch.tensor(np.asarray(windows)))
    assert ours.dtype == torch.float32
    ours_err = np.abs(ours.numpy() - ref32)
    jax_err = np.abs(ref16 - ref32)
    assert 0 < ours_err.mean() <= 1.5 * jax_err.mean()
    assert ours_err.max() <= 1.5 * jax_err.max()


def test_converter_is_strict(params):
    model = EDVR(**CFG)
    expected = model.state_dict()
    missing = jax.tree.map(lambda a: a, params)
    del missing["params"]["pcd_align"]["L1_dcnpack"]["bias"]
    with pytest.raises(KeyError, match="pcd_align.L1_dcnpack.bias"):
        jax_params_to_state_dict(missing, expected)
    wrong = jax.tree.map(lambda a: a, params)
    wrong["params"]["conv_last"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="conv_last.bias"):
        jax_params_to_state_dict(wrong, expected)
    sd = jax_params_to_state_dict(params, expected)
    sd.pop("conv_first.weight")
    with pytest.raises(RuntimeError, match="conv_first.weight"):
        model.load_state_dict(sd, strict=True)
