"""The port's nets start from the JAX package's initial weights, in
distribution: the same tensors are zero (every conv bias, EDVR's
conv_offset_mask) and every other tensor has JAX's spread (flax's
initialisers: `variance_scaling(1/3, "fan_in", "uniform")` for EDVR's
convs, kaiming-normal * 0.1 for its residual blocks, kaiming-normal for the
DCN weight, lecun-normal for MFDN / SFDN / TOFlow / DUF, BatchNorm scales
one). Training from scratch, as the quality protocol does, starts where
JAX's starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.networks import define_G as jax_define_G
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.networks import define_G
from torch_one_thread import one_thread  # noqa: F401

NETS = {
    "EDVR": ({"which_model_G": "EDVR", "nf": 16, "nframes": 5, "groups": 8, "front_RBs": 2,
              "back_RBs": 2}, (1, 5, 16, 16, 3)),
    "MFDN": ({"which_model_G": "MFDN", "nf": 64}, (1, 5, 16, 16, 3)),
    "SFDN": ({"which_model_G": "SFDN", "nf": 64}, (1, 5, 16, 16, 3)),
    "TOF": ({"which_model_G": "TOF", "nframes": 3}, (1, 3, 16, 16, 3)),
    "DUF": ({"which_model_G": "DUF_16L", "nframes": 7}, (1, 7, 8, 8, 3)),
}


@pytest.mark.parametrize("net", list(NETS))
def test_initial_weights_follow_jax(net):
    """Per tensor: zero where JAX's is zero, equal where JAX's is a
    constant, and otherwise a standard deviation within 15 % of JAX's
    (tensors of 256 entries or more; the two draws come from different
    random streams)."""
    g, shape = NETS[net]
    opt = {"scale": 4, "network_G": g}
    variables = jax.tree.map(np.asarray, jax.jit(jax_define_G(opt).init)(
        jax.random.PRNGKey(0), jnp.zeros(shape)))
    torch.manual_seed(0)
    model = (build_estimator(g, 4, shape[1], device="cpu") if net in ("MFDN", "SFDN")
             else define_G(opt, device="cpu"))
    got = model.state_dict()
    want = jax_params_to_state_dict(variables, got)
    checked = 0
    for k, t in got.items():
        if not t.is_floating_point() or k.endswith(("running_mean", "running_var")):
            continue
        a, b = t.double(), want[k].double()
        assert bool((a == 0).all()) == bool((b == 0).all()), (k, float(a.abs().max()),
                                                              float(b.abs().max()))
        if bool((b == b.flatten()[0]).all()):  # a constant: BatchNorm's ones, zeros
            assert torch.equal(a, b), k
        elif a.numel() >= 256:
            ratio = float(a.std() / b.std())
            assert abs(ratio - 1) < 0.15, (k, ratio)
            checked += 1
    assert checked >= 4, checked
