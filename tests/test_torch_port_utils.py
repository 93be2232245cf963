"""The port's small utilities against the JAX package's, on CPU:
utils/observability.profile_trace, utils/util.ProgressBar,
data/io.read_img_seq and get_image_paths (an image tree written here with
cv2, and an LMDB written with the port's writer). Clocks are replaced by
fixed sequences, so both packages see the same times; equality is exact.
"""

import itertools
import os
import time

import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.data.io import get_image_paths, read_img_seq
from dynavsr_tpu_torch.utils.observability import profile_trace
from dynavsr_tpu_torch.utils.util import ProgressBar

def _clock(monkeypatch, name, values):
    it = iter(values)
    monkeypatch.setattr(time, name, lambda: next(it))


@pytest.mark.parametrize("task_num", [0, 3])
def test_progress_bar_matches_jax(monkeypatch, capsys, task_num):
    """The reference's terminal bar, character for character, with and
    without a task count."""
    from dynavsr_tpu.utils.util import ProgressBar as JaxProgressBar

    out = {}
    for name, cls in (("jax", JaxProgressBar), ("port", ProgressBar)):
        _clock(monkeypatch, "time", itertools.count(100.0, 0.75))
        bar = cls(task_num)
        for i in range(3):
            bar.update(f"clip {i}")
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert ("3/3" if task_num else "completed: 3") in out["port"]


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Two clips of PNG frames (one nested a level deeper, one frame in
    grayscale) and a stray text file."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(0)
    for clip, n in (("a", 3), (os.path.join("b", "0001"), 2)):
        (root / clip).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
            cv2.imwrite(str(root / clip / f"{i:08d}.png"), img if i else img[..., 0])
    (root / "a" / "notes.txt").write_text("not a frame")
    return root


def test_get_image_paths_and_read_img_seq_match_jax(image_tree, tmp_path):
    """'img': the same sorted paths; read_img_seq: the same float32 RGB
    clip, bitwise; 'lmdb': the same sorted keys without the '.meta'
    entries; an unknown data_type raises in both."""
    from dynavsr_tpu.data import io as jax_io
    from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter

    paths = get_image_paths("img", str(image_tree))
    assert paths == jax_io.get_image_paths("img", str(image_tree)) and len(paths) == 5
    for clip in ("a", os.path.join("b", "0001")):
        frames = [p for p in paths if os.path.dirname(p) == str(image_tree / clip)]
        got = read_img_seq(frames)
        assert got.dtype == np.float32 and got.shape == (len(frames), 6, 5, 3)
        np.testing.assert_array_equal(got, jax_io.read_img_seq(frames))
    lmdb = str(tmp_path / "x.lmdb")
    with LmdbWriter(lmdb) as w:
        for key in ("clip_00000001", "clip_00000000", "other_00000000"):
            w.put(key.encode(), b"\0" * 12)
            w.put(f"{key}.meta".encode(), b"2x2x3")
    keys = get_image_paths("lmdb", lmdb)
    assert keys == jax_io.get_image_paths("lmdb", lmdb) == [
        "clip_00000000", "clip_00000001", "other_00000000"]
    for fn in (get_image_paths, jax_io.get_image_paths):
        with pytest.raises(ValueError, match="data_type"):
            fn("zarr", str(image_tree))


def test_profile_trace_writes_a_trace(tmp_path):
    """profile_trace writes a Chrome trace of the block on the CPU (the
    profiler's key averages name the block's op); enabled=False profiles
    and writes nothing."""
    on, off = tmp_path / "on", tmp_path / "off"
    x = torch.rand(64, 64)
    with profile_trace(str(on)) as prof:
        torch.mm(x, x)
    traces = list(on.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "aten::mm" in {e.key for e in prof.key_averages()}
    with profile_trace(str(off), enabled=False) as prof:
        torch.mm(x, x)
    assert prof is None and not off.exists()
