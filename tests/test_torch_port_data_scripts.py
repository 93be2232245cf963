"""The port's data-preparation scripts (dynavsr_tpu_torch/data_scripts/)
against the repo's JAX ones (data_scripts/), on CPU, on a two-clip PNG
tree drawn from a seed: create_lmdb writes the same keys and bytes;
generate_mod_LR_bic writes the same mod-cropped GT and LR frames within
one uint8 level (bicubic and duf modes). The port's scripts run with
neither jax nor the JAX package importable."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dynavsr_tpu_torch.data.lmdb_native import LmdbReader
from dynavsr_tpu_torch.data_scripts import create_lmdb, generate_mod_LR_bic

ROOT = Path(__file__).resolve().parents[1]
# Frame sizes off the scale's multiple, so the mod-crop cuts.
FRAME_H, FRAME_W, N_FRAMES = 50, 67, 3


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "data_scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """Two clips of N_FRAMES smooth-plus-noise colour frames, as PNGs."""
    root = tmp_path_factory.mktemp("tree") / "clips"
    rng = np.random.default_rng(0)
    for clip in ("000", "011"):
        os.makedirs(root / clip)
        base = rng.random((FRAME_H // 5 + 1, FRAME_W // 5 + 1, 3)).astype(np.float32)
        for i in range(N_FRAMES):
            smooth = cv2.resize(np.roll(base, i, axis=1), (FRAME_W, FRAME_H),
                                interpolation=cv2.INTER_CUBIC)
            img = np.clip(smooth + 0.1 * rng.standard_normal(smooth.shape), 0, 1)
            cv2.imwrite(str(root / clip / f"{i:08d}.png"),
                        (img * 255).round().astype(np.uint8))
    return root


def _entries(path: str) -> dict:
    with LmdbReader(path) as r:
        return dict(r.items())


def test_create_lmdb_matches_jax_script(png_tree, tmp_path):
    """The same keys ('<clip>_<frame:08d>') and the same value bytes (the
    PNG files passed through) as the JAX script's LMDB."""
    want, got = str(tmp_path / "jax.lmdb"), str(tmp_path / "port.lmdb")
    _jax_script("create_lmdb").main(["--input", str(png_tree), "--output", want])
    create_lmdb.main(["--input", str(png_tree), "--output", got])
    want_entries, got_entries = _entries(want), _entries(got)
    assert len(got_entries) == 2 * N_FRAMES
    assert sorted(got_entries) == sorted(want_entries)
    assert got_entries == want_entries
    assert got_entries[b"011_00000002"] == (png_tree / "011" / "00000002.png").read_bytes()


def _frames(root: Path) -> dict:
    return {str(p.relative_to(root)): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("mode", ["bicubic", "duf"])
def test_generate_mod_lr_matches_jax_script(png_tree, tmp_path, mode):
    """GT: the mod-4 crop, identical to the JAX script's. LR: the port's
    fp32 imresize (float64 in the JAX script's imresize_np) or
    duf_downsample, within one uint8 level of the JAX script's, and all but
    a few pixels exactly."""
    want, got = tmp_path / "jax", tmp_path / "port"
    _jax_script("generate_mod_LR_bic").main(["--input", str(png_tree), "--output", str(want),
                                             "--mode", mode])
    generate_mod_LR_bic.main(["--input", str(png_tree), "--output", str(got), "--mode", mode,
                              "--device", "cpu"])
    for leg, shape in (("GT", (48, 64, 3)), ("LRx4", (12, 16, 3))):
        want_frames, got_frames = _frames(want / leg), _frames(got / leg)
        assert sorted(got_frames) == sorted(want_frames) and len(got_frames) == 2 * N_FRAMES
        n = same = 0
        for name, w in want_frames.items():
            g = got_frames[name]
            assert g.shape == w.shape == shape and g.dtype == np.uint8, (leg, name)
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            if leg == "GT":
                assert not diff.any(), name
            assert int(diff.max()) <= 1, (leg, name)
            n, same = n + diff.size, same + int((diff == 0).sum())
        assert same >= 0.99 * n, (leg, same, n)


def test_scripts_run_without_jax_or_the_jax_package(png_tree, tmp_path):
    """Both scripts run as `python -m` with jax, flax and the JAX package
    made unimportable, and leave the same outputs as in-process runs."""
    block = (
        "import importlib.abc, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dynavsr_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "mod = sys.argv.pop(1)\n"
        "sys.argv[0] = mod\n"
        "runpy.run_module(mod, run_name='__main__')\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = tmp_path / "out"
    for mod, extra in (("create_lmdb", ["--output", str(tmp_path / "a.lmdb")]),
                       ("generate_mod_LR_bic", ["--output", str(out), "--device", "cpu"])):
        res = subprocess.run([sys.executable, "-c", block, f"dynavsr_tpu_torch.data_scripts.{mod}",
                              "--input", str(png_tree)] + extra, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    assert len(_entries(str(tmp_path / "a.lmdb"))) == 2 * N_FRAMES
    assert len(_frames(out / "LRx4")) == 2 * N_FRAMES
