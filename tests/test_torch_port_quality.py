"""The port's blind-adaptation quality protocol
(dynavsr_tpu_torch/tools/blind_adaptation_check.py) against the JAX tool
(tools/blind_adaptation_check.py), on CPU: the kernels it parses, the
frames its raw-byte LMDB trees give the port's datasets against the frames
the JAX tool's PNG trees give the JAX package's, a tiny run end to end
through `main`, and the dict entry points `cli.test.run` /
`cli.test_dynavsr.run` against their YAML `main`s."""

import ast
import contextlib
import copy
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dynavsr_tpu_torch.cli import test as port_test_cli
from dynavsr_tpu_torch.cli import test_dynavsr as port_dynavsr_cli
from dynavsr_tpu_torch.config.options import derive
from dynavsr_tpu_torch.data.datasets import VideoTestDataset
from dynavsr_tpu_torch.tools import blind_adaptation_check as tool
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_TOOL = ROOT / "tools" / "blind_adaptation_check.py"
SPECS = ("iso:1.8", "iso:1.2:n0.03", "aniso:2.4:1.2:0.79", "aniso:2.4:1.2:0.79:n0.05")
TINY = ["--device", "cpu", "--iters", "2", "--mfdn-iters", "2", "--meta-iters", "1",
        "--adapt-steps", "1", "--adapt-lrs", "1e-5", "--kernels", "iso:1.8", "--nf", "8",
        "--front-rbs", "1", "--back-rbs", "1"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_blind_adaptation_check", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spec", SPECS)
def test_parse_kernel_matches_jax_tool(spec):
    """The tag, the 13x13 kernel (1e-7: both normalise an fp32 Gaussian)
    and the noise sigma of each spec form; a bad spec raises in both."""
    want_tag, want_k, want_noise = _jax_tool().parse_kernel(spec)
    tag, k, noise = tool.parse_kernel(spec)
    assert (tag, noise) == (want_tag, want_noise)
    assert k.shape == (13, 13) and k.dtype == np.float32
    np.testing.assert_allclose(k, np.asarray(want_k), rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        tool.parse_kernel("box:3")


def test_lmdb_trees_match_jax_tool_png_trees(tmp_path):
    """The same seed through the JAX tool (cv2 resize, PNG folders) and the
    port's tool (F.interpolate, raw-byte LMDBs), at a reduced make_gt (1
    train and 1 val clip of 3 frames of 64x64): GT and LQ_bic of both
    splits and a blurred val leg with noise, read by each package's
    VideoTestDataset, agree within one uint8 level, and all but a few
    pixels exactly."""
    from dynavsr_tpu.data.datasets import VideoTestDataset as JaxVideoTestDataset

    jax_tool = _jax_tool()
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    reduced = dict(n_clips=1, frames=3, gh=64, gw=64, val_clips=1)
    jax_tool.make_gt(jroot, 0, **reduced)
    tool.make_gt(proot, 0, **reduced)
    spec = "aniso:2.4:1.2:0.79:n0.03"
    tag, k, noise = jax_tool.parse_kernel(spec)
    jax_tool.make_blur_leg(jroot, tag, np.asarray(k), noise)
    tag_p, k_p, noise_p = tool.parse_kernel(spec)
    tool.make_blur_leg(proot, tag_p, k_p, noise_p)
    legs = [("train", "LQ_bic"), ("val", "LQ_bic"), ("val", f"LQ_{tag}")]
    n = same = 0
    for split, leg in legs:
        want_set = JaxVideoTestDataset({"dataroot_GT": f"{jroot}/{split}/GT",
                                        "dataroot_LQ": f"{jroot}/{split}/{leg}"})
        got_set = VideoTestDataset({"dataroot_GT": f"{proot}/{split}/GT.lmdb",
                                    "dataroot_LQ": f"{proot}/{split}/{leg}.lmdb"})
        assert got_set.names == want_set.names
        for clip in want_set.names:
            for gt in (True, False):
                want, got = want_set.clip_frames(clip, gt), got_set.clip_frames(clip, gt)
                assert got.shape == want.shape and got.dtype == want.dtype
                diff = np.abs(got - want)
                assert float(diff.max()) <= 1.0 / 255 + 1e-6, (split, leg, clip, gt)
                n, same = n + diff.size, same + int((diff == 0).sum())
    assert same >= 0.999 * n, (same, n)


def _json_keys(path: Path, marker: str) -> set:
    """The string keys of the dict literal in `path` that holds `marker`."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict) and all(isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if marker in keys:
                return keys
    raise AssertionError(f"no dict with {marker!r} in {path}")


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """`main` on TINY in a fresh run dir: (exit code, its JSON line, the dir)."""
    root = str(tmp_path_factory.mktemp("blind"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(TINY + ["--root", root])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1]), root


def test_tiny_protocol_runs_on_cpu(tiny_run):
    """2 supervised updates, 2 MFDN updates, 1 second-order meta update, 1
    adaptation step at one lr: the run ends with the JAX tool's JSON keys
    (and per kernel its keys), finite PSNRs, and the exit code its own
    verdict gives."""
    rc, record, root = tiny_run
    assert set(record) == _json_keys(JAX_TOOL, "mean_gain_db")
    assert set(record["per_kernel"]) == {"iso1.8"}
    leg = record["per_kernel"]["iso1.8"]
    assert set(leg) == _json_keys(JAX_TOOL, "adaptation_gain_db")
    assert record["meta_iters"] == 1 and record["adapt_steps"] == 1
    assert all(np.isfinite(v) for v in (record["psnr_bicubic_matched"], leg["psnr_no_adapt"],
                                        leg["psnr_adapted"], leg["mfdn_rmse_vs_true_slr"]))
    assert rc == (0 if record["mean_gain_db"] > 0.05 else 1)
    for name in ("vsr_edvr_nf8_rb1x1/models/2_G.pth", "mfdn_n5/models/2_G.pth",
                 "meta_edvr_nf8_rb1x1/models/1_G.pth"):
        assert os.path.exists(f"{root}/experiments/{name}"), name


def test_cli_run_matches_main_on_the_same_yaml(tiny_run, tmp_path):
    """cli.test.run and cli.test_dynavsr.run on a config dict derived in
    Python give what each main gives on the same config as a YAML file (a
    1-clip, 4-frame val set of 64x64 written by make_gt, the tiny run's
    checkpoints)."""
    _, _, root = tiny_run
    data = str(tmp_path / "data")
    tool.make_gt(data, 1, n_clips=0, frames=4, gh=64, gw=64, val_clips=1)
    net_g = {"which_model_G": "EDVR", "nf": 8, "nframes": 5, "groups": 8, "front_RBs": 1,
             "back_RBs": 1, "dtype": "bfloat16"}
    plain = {
        "name": "bic", "model": "video_base", "scale": 4,
        "path": {"root": str(tmp_path), "pretrain_model_G":
                 f"{root}/experiments/vsr_edvr_nf8_rb1x1/models/2_G.pth"},
        "datasets": {"test": {"name": "bic", "mode": "video_test",
                              "dataroot_GT": f"{data}/val/GT.lmdb",
                              "dataroot_LQ": f"{data}/val/LQ_bic.lmdb",
                              "N_frames": 5, "padding": "reflection"}},
        "network_G": net_g, "eval": {"ycbcr": True, "crop_border": 4}}
    adapted = copy.deepcopy(plain)
    adapted["name"] = "adapted"
    adapted["path"]["pretrain_model_E"] = f"{root}/experiments/mfdn_n5/models/2_G.pth"
    adapted["network_E"] = {"which_model_G": "MFDN", "nf": 64}
    adapted["adapt"] = {"n_steps": 1, "lr": 1e-5, "optimizer": "adam", "n_windows": 2}
    cpu = torch.device("cpu")
    for opt, cli, pick in ((plain, port_test_cli, lambda r: r["test"]),
                           (adapted, port_dynavsr_cli, lambda r: r)):
        path = tmp_path / f"{opt['name']}.yml"
        path.write_text(yaml.safe_dump(opt, sort_keys=False))
        want = pick(cli.main(["-opt", str(path), "--no-save-images", "--device", "cpu"]))
        got = pick(cli.run(derive(copy.deepcopy(opt)), cpu, True))
        assert set(got) == set(want) and "_avg" in got
        for clip, scores in want.items():
            for k in ("psnr_avg", "ssim_avg"):
                assert got[clip][k] == pytest.approx(scores[k], abs=1e-9), (clip, k)


def test_port_and_tool_import_no_jax_cv2_or_yaml():
    """Importing every module of the package, the tool and chip_smoke.py
    loads none of jax, flax, optax, the JAX package, cv2 or yaml."""
    import pkgutil

    import dynavsr_tpu_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(dynavsr_tpu_torch.__path__,
                                                        "dynavsr_tpu_torch."))
    assert "dynavsr_tpu_torch.tools.blind_adaptation_check" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'dynavsr_tpu', 'cv2', 'yaml')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
