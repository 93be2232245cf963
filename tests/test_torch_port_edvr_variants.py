"""The port's EDVR variants against the JAX EDVR, on CPU: `predeblur`,
`HR_in`, both, and `w_TSA: false`.

Tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 residual blocks). Weights are the
JAX EDVR's params drawn at He scale (the residual blocks' at a tenth of it, as
the reference initialises them, so the pre-deblur pyramid's eight blocks
stay O(1); the offset convs at 0.3, so the DCNs sample off the grid),
carried over by convert/from_jax.py:jax_params_to_state_dict. LR windows
are 8x12; `HR_in` takes 32x48 HR windows (the DCNs then run at 8x12) and
returns SR at the input's size. Tolerances, relative to the largest
reference value: forward 2e-5, gradients 1e-4 (fp32; convs, the DCN and
the pre-deblur pyramid sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.data.windows import all_windows
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.networks import define_G
from torch_one_thread import one_thread  # noqa: F401

CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
VARIANTS = {"predeblur": dict(predeblur=True), "hr_in": dict(hr_in=True),
            "predeblur_hr_in": dict(predeblur=True, hr_in=True), "no_tsa": dict(w_TSA=False)}
# The same networks as network_G blocks of a config.
OPTS = {"predeblur": {"predeblur": True}, "hr_in": {"HR_in": True},
        "predeblur_hr_in": {"predeblur": True, "HR_in": True}, "no_tsa": {"w_TSA": False}}


def _perturb(tree, rng, name="", in_block=False):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng, k, in_block or k.startswith(("RB_", "blocks")))
        elif k in ("kernel", "weight"):
            fan_in = np.prod(v.shape[-4:-1])
            gain = 0.3 if name == "conv_offset_mask" else (2.0 / fan_in) ** 0.5
            tree[k] = (rng.standard_normal(v.shape) * gain * (0.1 if in_block else 1.0)
                       ).astype(np.float32)
        else:
            tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_edvr_variant_matches_jax(variant):
    """Forward, and the gradients of <SR, cotangent> in the input windows
    and in every weight, against JAX (one jitted vjp); the network built
    from a network_G block through define_G; forward_seq equal to the
    window forward on 5 frames (the same math: 1e-6)."""
    hr = VARIANTS[variant].get("hr_in", False)
    h, w = (32, 48) if hr else (8, 12)
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, h, w, 3)).astype(np.float32)
    jnet = JaxEDVR(**CFG, **VARIANTS[variant])
    # Every leaf is redrawn, so only the params' structure is needed (no init run).
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    _perturb(params["params"], rng)
    out_hw = (h, w) if hr else (4 * h, 4 * w)
    cot = rng.standard_normal((2, *out_hw, 3)).astype(np.float32)

    def fwd_vjp(p, v):
        out, vjp = jax.vjp(jnet.apply, p, v)
        return out, vjp(jnp.asarray(cot))

    ref, (g_params, g_x) = jax.jit(fwd_vjp)(params, jnp.asarray(x))

    model = define_G({"scale": 4, "network_G": {"which_model_G": "EDVR", **CFG,
                                                 **OPTS[variant]}}, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params, model.state_dict()), strict=True)
    model.eval()
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    assert out.shape == ref.shape == (2, *out_hw, 3)
    assert _rel(out.detach().numpy(), ref) <= 2e-5
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad.numpy(), g_x) <= 1e-4
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, g_params))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(), atol=1e-4 * scale, err_msg=k)

    frames = rng.random((5, h, w, 3)).astype(np.float32)
    win = all_windows(5, 3, "reflection")
    with torch.no_grad():
        by_window = model(torch.from_numpy(frames[win]))
        seq = model.forward_seq(torch.from_numpy(frames), torch.from_numpy(win).long())
    torch.testing.assert_close(seq, by_window, rtol=0, atol=1e-6)
