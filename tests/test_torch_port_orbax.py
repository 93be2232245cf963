"""The JAX package's orbax network checkpoints read by the port through
tools/orbax_to_pth.py, on CPU: JAX's save_network on a tiny EDVR, a TOFlow
(BatchNorm statistics), a DUF (5-D kernels, BatchNorm statistics) and an
MFDN; the script's .pth through the port's load_pretrained gives JAX's
forward within 1e-5 in fp32 (eval mode: the BatchNorm nets on their
converted running statistics). The weights are numpy draws into
jax.eval_shape templates, so JAX compiles only the four forwards."""

import importlib.util
import os.path as osp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
from dynavsr_tpu.models.duf import DUF as JaxDUF
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu.train.checkpoint import save_network
from dynavsr_tpu_torch.models.downscaler import MFDN
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.tof import TOFlow
from dynavsr_tpu_torch.train.checkpoint import load_pretrained
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EDVR_CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
NETS = {
    "EDVR": (lambda: JaxEDVR(**EDVR_CFG), lambda: EDVR(**EDVR_CFG), (1, 3, 16, 16, 3)),
    "TOF": (JaxTOFlow, lambda: TOFlow(nframes=3), (1, 3, 16, 16, 3)),
    "DUF": (lambda: JaxDUF(dense1_layers=1), lambda: DUF(dense1_layers=1), (1, 7, 8, 8, 3)),
    "MFDN": (lambda: JaxMFDN(nf=8), lambda: MFDN(nf=8, nframes=3), (1, 3, 16, 16, 3)),
}


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_pth", ROOT / "tools" / "orbax_to_pth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fill(template, rng):
    """Numpy draws of the template's shapes: conv / dense kernels N(0,
    1 / fan_in) (a stacked residual block's leading axis is not fan-in),
    biases N(0, 0.01^2), BatchNorm scales 1 + N(0, 0.1^2), running means
    N(0, 0.1^2), running variances U(0.5, 1.5)."""
    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape, name = leaf.shape, names[-1]
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("mean", "bias"):
            std = 0.1 if name == "mean" else 0.01
            return (std * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[1 if "blocks" in names else 0:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


@pytest.mark.parametrize("net", list(NETS))
def test_orbax_checkpoint_converts_to_the_ports_forward(net, tmp_path):
    make_jax, make_port, shape = NETS[net]
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    jax_model = make_jax()
    template = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(template, rng)
    if net in ("TOF", "DUF"):
        assert set(variables) == {"params", "batch_stats"}
    ckpt = save_network(str(tmp_path / "models"), 7, variables)
    assert osp.basename(ckpt) == "7_G" and osp.isdir(ckpt)
    model = make_port()
    out = str(tmp_path / f"{net}.pth")
    state = _script().convert(ckpt, out, expected=model.state_dict())
    assert set(state) == set(model.state_dict())
    if net == "DUF":
        assert any(v.dim() == 5 for v in state.values())
    load_pretrained(model, out)
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_script_checks_against_a_config_and_the_port_names_it(tmp_path):
    """main with -opt: the tiny EDVR's checkpoint matches the net its config
    builds; a config whose net differs (nf 16) is refused. The port's
    loader, handed the orbax directory itself, raises naming the script."""
    jax_model = JaxEDVR(**EDVR_CFG)
    x = jnp.zeros((1, 3, 16, 16, 3))
    variables = _fill(jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), x),
                      np.random.default_rng(1))
    ckpt = save_network(str(tmp_path / "models"), 3, variables)
    script = _script()
    for nf, ok in ((8, True), (16, False)):
        yml = tmp_path / f"nf{nf}.yml"
        yml.write_text(yaml.safe_dump({"name": "t", "scale": 4, "network_G": {
            "which_model_G": "EDVR", **EDVR_CFG, "nf": nf}}))
        out = str(tmp_path / f"nf{nf}.pth")
        if ok:
            assert script.main([ckpt, out, "-opt", str(yml)]) == 0
            model = EDVR(**EDVR_CFG)
            load_pretrained(model, out)
        else:
            with pytest.raises(ValueError, match="converted shape"):
                script.main([ckpt, out, "-opt", str(yml)])
    with pytest.raises(NotImplementedError, match="tools/orbax_to_pth.py"):
        load_pretrained(EDVR(**EDVR_CFG), ckpt)
