"""Package-level contract of the port: it imports no JAX and nothing of
the JAX package, its entry points refuse to run on a host without a card
unless asked for the CPU, the DCN wrapper sends CPU tensors to the plain
version without counting a launch, chip_smoke.py fails without a card, and
the CLI runs end to end on CPU from a YAML config and image folders."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dynavsr_tpu_torch
from dynavsr_tpu_torch.ops import dcn
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref

ROOT = Path(__file__).resolve().parents[1]


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(dynavsr_tpu_torch.__path__,
                                                        "dynavsr_tpu_torch."))


def test_package_imports_no_jax():
    mods = _submodules()
    assert {"dynavsr_tpu_torch.ops.dcn", "dynavsr_tpu_torch.cli.test_dynavsr",
            "dynavsr_tpu_torch.cli.test", "dynavsr_tpu_torch.models.video_base_model",
            "dynavsr_tpu_torch.data.loader", "dynavsr_tpu_torch.train.checkpoint"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'optax', 'dynavsr_tpu.')) or m == 'dynavsr_tpu']\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "dynavsr_tpu_torch.cli.test_dynavsr" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "flax", "optax", "dynavsr_tpu")]


def test_chip_smoke_fails_without_a_card(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


TINY_G = {"which_model_G": "EDVR", "nf": 8, "nframes": 3, "groups": 2, "front_RBs": 1,
          "back_RBs": 1}


def test_entry_points_refuse_the_cpu_unless_asked():
    from dynavsr_tpu_torch import resolve_device
    from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
    from dynavsr_tpu_torch.cli import test as test_cli
    from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, main, run_clip
    from dynavsr_tpu_torch.models.networks import define_G
    from dynavsr_tpu_torch.models.video_base_model import VideoBaseModel

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-opt", str(ROOT / "configs/test/test_DynaVSR_Vid4.yml")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main(["-opt", str(ROOT / "configs/test/test_EDVR_M_REDS4.yml")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoBaseModel({"network_G": TINY_G})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        define_G({"network_G": TINY_G})
    for which in ("MFDN", "SFDN"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_estimator({"which_model_G": which, "nf": 8}, 4, 3)
    assert VideoBaseModel({"network_G": TINY_G}, device="cpu").netG.arch == "EDVR"
    vsr = define_G({"network_G": TINY_G}, device="cpu")
    est = build_estimator({"nf": 8}, 4, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_clip(vsr, est, np.zeros((3, 8, 8, 3), np.float32), None, AdaptConfig(n_steps=1),
                 seq=False, n_frames=3, padding="reflection", n_adapt=1)
    assert resolve_device("cpu").type == "cpu"


def test_run_clip_refuses_modules_off_its_device():
    """The models are built on the CPU; a clip asked to run elsewhere raises
    rather than moving them or running where they are."""
    from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
    from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, run_clip
    from dynavsr_tpu_torch.models.networks import define_G

    vsr = define_G({"network_G": TINY_G}, device="cpu")
    est = build_estimator({"nf": 8}, 4, 3, device="cpu")
    assert {p.device.type for p in [*vsr.parameters(), *est.parameters()]} == {"cpu"}
    assert not est.training
    with pytest.raises(ValueError, match="vsr is on cpu"):
        run_clip(vsr, est, np.zeros((3, 8, 8, 3), np.float32), None, AdaptConfig(n_steps=1),
                 seq=False, n_frames=3, padding="reflection", n_adapt=1, device="meta")


def test_cli_runs_on_cpu_from_yaml(tmp_path):
    """main() on a two-clip image-folder dataset, tiny EDVR, device='cpu';
    one clip has no GT, and the average covers only the scored clip."""
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.cli.test_dynavsr import main

    rng = np.random.default_rng(0)
    for clip, t in (("calendar", 6), ("city", 5)):
        for i in range(t):
            for root, (h, w) in (("LQ", (16, 20)), ("GT", (64, 80))):
                if root == "GT" and clip == "city":
                    continue
                d = tmp_path / root / clip
                d.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(d / f"{i:08d}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    opt = tmp_path / "opt.yml"
    opt.write_text(f"""
name: tiny
scale: 4
datasets:
  test:
    mode: video_test
    dataroot_GT: {tmp_path / 'GT'}
    dataroot_LQ: {tmp_path / 'LQ'}
    padding: reflection
network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}}
network_E: {{which_model_G: MFDN, nf: 8}}
adapt: {{n_steps: 2, lr: 1.0e-4, n_windows: 4, infer_chunk: 4, seq: true}}
path: {{root: {tmp_path}}}
eval: {{ycbcr: true}}
""")
    res = main(["-opt", str(opt), "--device", "cpu", "--no-save-images"])
    assert np.isfinite(res["calendar"]["psnr_avg"]) and "psnr_avg" not in res["city"]
    assert res["_avg"]["psnr_avg"] == res["calendar"]["psnr_avg"]
    assert len(res["calendar"]["adapt_losses"]) == 2


def _dcn_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, 8, 6, 7, generator=g),
            torch.randn(1, 2 * 2 * 9, 6, 7, generator=g) * 2.0 + 0.37,
            torch.rand(1, 2 * 9, 6, 7, generator=g), torch.randn(8, 8, 3, 3, generator=g),
            torch.randn(8, generator=g))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, offset, mask, weight, bias = _dcn_inputs(seed=2)
    dcn.reset_launch_counts()
    out = dcn.deform_conv2d(x, offset, mask, weight, bias, deformable_groups=2)
    ref = deform_conv2d_ref(x, offset, mask, weight, bias, deformable_groups=2)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert dcn.launch_counts() == dict.fromkeys(
        ("dcn_fwd", "dcn_bwd_data", "dcn_bwd_weight", "dcn_fwd_tangent", "dcn_bwd_weight_tangent",
         "dcn_bwd_data_tangent"), 0)


def test_kernel_launchers_refuse_cpu_tensors():
    x, offset, mask, weight, bias = _dcn_inputs(seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        dcn.dcn_fwd(x, offset, mask, weight, bias, 2)
