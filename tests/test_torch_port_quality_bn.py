"""The quality protocol's BatchNorm legs on CPU: the port's tool
(dynavsr_tpu_torch/tools/blind_adaptation_check.py) end to end with
--arch tof and --arch duf at tiny iteration counts (the JAX tool's JSON
keys and checkpoint names), and tools/quality_same_weights.to_orbax on a
TOF and a DUF `.pth` with non-trivial BatchNorm running statistics: the
JAX tool's loader restores them from the orbax checkpoint, and JAX's eval
forward of that checkpoint is the port's."""

import contextlib
import importlib.util
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.networks import define_G as jax_define_G
from dynavsr_tpu.train.checkpoint import load_network
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.tools import blind_adaptation_check as tool
from test_torch_port_quality import JAX_TOOL, _json_keys
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--iters", "2", "--mfdn-iters", "2", "--meta-iters", "1",
        "--adapt-steps", "1", "--adapt-lrs", "1e-5", "--kernels", "iso:1.8"]
# --arch -> (its VSR net's checkpoint name, its MFDN's window)
BN_ARCHS = {"tof": ("vsr_tof", 5), "duf": ("vsr_duf", 7)}


def _same_weights():
    spec = importlib.util.spec_from_file_location("quality_same_weights",
                                                  ROOT / "tools" / "quality_same_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", list(BN_ARCHS))
def test_tiny_protocol_runs_on_cpu(arch, tmp_path):
    """2 supervised updates, 2 MFDN updates, 1 second-order meta update
    and 1 adaptation step (train_ema, the 'auto' mode of a BatchNorm net):
    the JAX tool's JSON keys, finite PSNRs, the exit code its verdict
    gives, and the JAX tool's checkpoint names (`vsr_<arch>`,
    `mfdn_n<window>`, `meta_<arch>`)."""
    root = str(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(TINY + ["--arch", arch, "--root", root])
    record = json.loads([ln for ln in out.getvalue().splitlines() if ln.startswith("{")][-1])
    assert set(record) == _json_keys(JAX_TOOL, "mean_gain_db")
    assert record["arch"] == arch and record["groups"] is None
    assert set(record["per_kernel"]) == {"iso1.8"}
    leg = record["per_kernel"]["iso1.8"]
    assert set(leg) == _json_keys(JAX_TOOL, "adaptation_gain_db")
    assert all(np.isfinite(v) for v in (record["psnr_bicubic_matched"], leg["psnr_no_adapt"],
                                        leg["psnr_adapted"], leg["mfdn_rmse_vs_true_slr"]))
    assert rc == (0 if record["mean_gain_db"] > 0.05 else 1)
    vsr_name, window = BN_ARCHS[arch]
    assert sorted(os.listdir(f"{root}/experiments")) == sorted(
        [vsr_name, f"mfdn_n{window}", f"meta_{arch}"])
    for name in (f"{vsr_name}/models/2_G.pth", f"mfdn_n{window}/models/2_G.pth",
                 f"meta_{arch}/models/1_G.pth"):
        assert os.path.exists(f"{root}/experiments/{name}"), name


def _batch_norm_stats(net: torch.nn.Module, rng: np.random.Generator) -> None:
    """Running means N(0, 0.1^2) and variances U(0.5, 1.5), so a loader that
    re-initialised them (0 and 1) would show."""
    for m in net.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.from_numpy(
                0.1 * rng.standard_normal(m.running_mean.shape).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))


def _flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", list(BN_ARCHS))
def test_to_orbax_converts_batch_norm_nets(arch, tmp_path):
    """A port-trained TOF / DUF checkpoint (random weights, running
    statistics drawn away from 0 / 1) and its MFDN go through to_orbax at
    the tool's network_G; the JAX tool's loader (load_network over the
    init's variables, as VideoBaseModel does) restores every running
    statistic as the `.pth` holds it, and JAX's eval forward of the
    restored variables is the port's eval forward within 1e-4 (both in
    fp32)."""
    vsr_name, window = BN_ARCHS[arch]
    net_g, name = tool.vsr_network(tool.build_parser().parse_args(["--arch", arch]))
    assert name == vsr_name
    torch_root, jax_root = tmp_path / "torch", tmp_path / "jax"
    rng = np.random.default_rng(3)
    fp32 = {**net_g, "dtype": "float32"}
    torch.manual_seed(3)
    net = define_G({"scale": 4, "network_G": fp32}, "cpu")
    with torch.no_grad():
        _batch_norm_stats(net, rng)
    est = define_G({"scale": 4, "network_G": {"which_model_G": "MFDN", "nf": 64,
                                              "nframes": window}}, "cpu")
    for what, module in ((vsr_name, net), (f"mfdn_n{window}", est)):
        os.makedirs(torch_root / "experiments" / what / "models")
        torch.save(module.state_dict(), torch_root / "experiments" / what / "models" / "2_G.pth")
    written = _same_weights().to_orbax(str(torch_root), str(jax_root), ["--arch", arch])
    assert sorted(os.path.relpath(w, jax_root) for w in written) == sorted(
        f"experiments/{what}/models/2_G" for what in (vsr_name, f"mfdn_n{window}"))

    x = rng.random((1, window, 16, 16, 3)).astype(np.float32)
    jax_net = jax_define_G({"scale": 4, "network_G": fp32})
    init = jax.jit(jax_net.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    assert set(init) == {"params", "batch_stats"}
    variables = load_network(str(jax_root / "experiments" / vsr_name / "models" / "2_G"),
                             like=init)
    stats = _flat(variables["batch_stats"])
    state = net.state_dict()
    assert stats
    for path, value in stats.items():
        *mods, leaf = path.split("/")
        key = ".".join(mods + ["running_mean" if leaf == "mean" else "running_var"])
        np.testing.assert_array_equal(value, state[key].numpy(), err_msg=path)
    assert not any(np.array_equal(v, init_v) for v, init_v in
                   zip(stats.values(), _flat(init["batch_stats"]).values()))
    want = np.asarray(jax.jit(jax_net.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    est_init = jax.jit(jax_define_G({"scale": 4, "network_G": {
        "which_model_G": "MFDN", "nf": 64}}).init)(jax.random.PRNGKey(0), jnp.asarray(x))
    est_vars = load_network(str(jax_root / "experiments" / f"mfdn_n{window}" / "models" / "2_G"),
                            like=est_init)
    est_state = est.state_dict()
    for path, value in _flat(est_vars).items():
        if path.endswith("kernel") and value.ndim == 4:
            key = ".".join(path.split("/")[1:-1] + ["weight"])
            np.testing.assert_array_equal(value, est_state[key].numpy().transpose(2, 3, 1, 0),
                                          err_msg=path)


def _flow_probe():
    spec = importlib.util.spec_from_file_location("tof_flow_probe",
                                                  ROOT / "tools" / "tof_flow_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The flows' mean |value| (over dx and dy) that each SpyNet level's warp
# sees when every level adds a constant b px in dx: level l warps with the
# flow of the levels below, doubled at each level (2b, 6b at 16 and 32 px);
# at 64 px SpyNet's last warp (14b) and TOFlow's own warp of the neighbour
# by the final flow (15b) average 14.5b.
LEVEL_FLOW_PER_PX = {"16x16": 1.0, "32x32": 3.0, "64x64": 7.25}


@pytest.mark.parametrize("flow_px", [0.0, 100.0])
def test_tof_flow_probe_reads_flows_and_dead_spynet(flow_px, tmp_path):
    """tools/tof_flow_probe.py on a val clip the tool writes (1 clip of 5
    frames, 64x64): SpyNet's last convs zeroed but for a bias of `flow_px`
    px in dx, so every level adds that much. At 0 px no sample leaves the
    frame and SpyNet's blocks get a gradient; at 100 px every sample past
    the first level lands in the warp's zero padding, and no gradient
    reaches the blocks whose flows only feed such warps (the reading that
    tells a dead flow estimator)."""
    data = str(tmp_path / "data")
    tool.make_gt(data, 0, n_clips=0, frames=5, gh=64, gw=64, val_clips=1)
    probe = _flow_probe()
    torch.manual_seed(0)
    net = define_G({"scale": 4, "network_G": probe.NET_G}, "cpu")
    with torch.no_grad():
        for lvl in range(net.spynet.levels):
            conv4 = getattr(net.spynet, f"block{lvl}").conv4
            conv4.weight.zero_()
            conv4.bias.copy_(torch.tensor([flow_px, 0.0]))
    pth = str(tmp_path / "tof.pth")
    torch.save(net.state_dict(), pth)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert probe.main(["--data", data, pth]) == 0
    reading = json.loads(out.getvalue().splitlines()[-1])
    assert list(reading["flows"]) == ["8x8", "16x16", "32x32", "64x64"]
    assert reading["flows"]["8x8"] == {"absmean_px": 0.0, "off_frame_share": 0.0}
    for size, per_px in LEVEL_FLOW_PER_PX.items():
        assert reading["flows"][size]["absmean_px"] == pytest.approx(per_px * flow_px, rel=1e-6)
        assert reading["flows"][size]["off_frame_share"] == (1.0 if flow_px else 0.0)
    spy = [reading["grad_norm"][f"spynet.block{lvl}"] for lvl in range(4)]
    assert reading["grad_norm"]["fusion"] > 0 and np.isfinite(reading["l1"])
    if flow_px:
        assert spy == [0.0, 0.0, 0.0, 0.0]
    else:
        assert all(g > 0 for g in spy)
