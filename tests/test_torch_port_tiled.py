"""The port's tiled inference (eval/tiled.py) on CPU, against the JAX
package's and against the whole-frame forward.

`tile_plan` equals JAX's. Tiled equals whole-frame where the net's
receptive field is bounded and the overlap covers it: a toy 2-conv net
(radius 2; JAX's test_tiled_apply_exact_vs_full) and a tiny DUF-16L
(JAX's slow DUF case: 3 dense layers, 32x36, tile 28, overlap 12). EDVR's
deformable offsets are unbounded, so tiled EDVR is held against JAX's
tiled EDVR (the port's weights carried into JAX params by the JAX
package's `.pth` importer), not against its own whole frame. Both CLIs take
`eval.tile` and agree with the JAX CLIs on one tree of PNGs and the same
`.pth` files. Inputs are numpy draws from a seed; tolerances are stated
per test.
"""

import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynavsr_tpu_torch.eval.tiled import TILE_OVERLAP, make_tiled_apply, tile_plan
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.video_base_model import VideoBaseModel
from torch_one_thread import one_thread  # noqa: F401

TINY = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)


def _frames(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


PLANS = [(d, t, ov) for d in (1, 7, 16, 33, 41, 64) for t in (4, 8, 12, 16, 33, 64)
         for ov in (0, 1, 2, 3, 5)]


def test_tile_plan_matches_jax():
    """Starts and cores equal JAX's on every (d, t, ov) of the grid, t >= d
    (one tile) included; where JAX raises (2*ov >= t, ov < 0), so does the
    port."""
    from dynavsr_tpu.eval.tiled import tile_plan as jax_tile_plan

    raised = 0
    for d, t, ov in PLANS + [(10, 6, -1), (32, 8, 4)]:
        try:
            want = jax_tile_plan(d, t, ov)
        except ValueError:
            raised += 1
            with pytest.raises(ValueError, match="overlap"):
                tile_plan(d, t, ov)
            continue
        starts, cores = tile_plan(d, t, ov)
        assert (list(starts), [tuple(c) for c in cores]) == (
            list(want[0]), [tuple(c) for c in want[1]]), (d, t, ov)
        assert cores[0][0] == 0 and starts[-1] + cores[-1][1] == d
    assert raised >= 2


def _toy_apply(k1, k2):
    def apply(_model, x):  # (F, N, h, w, 3) -> (F, 2h, 2w, 3), RF radius 2
        y = x[:, x.shape[1] // 2].permute(0, 3, 1, 2)
        for k in (k1, k2):
            y = F.conv2d(y, k, padding=1)
        y = y.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return y.permute(0, 2, 3, 1)
    return apply


def test_tiled_apply_exact_vs_full():
    """Toy 2 x 3x3 conv net (receptive-field radius 2): tiled equals the
    whole frame within 1e-5 for overlaps >= 2, and the wrapper passes
    through (bitwise) when the frame fits one tile."""
    k1 = torch.tensor(_frames((8, 3, 3, 3), 3, 0.3))
    k2 = torch.tensor(_frames((3, 8, 3, 3), 4, 0.3))
    apply = _toy_apply(k1, k2)
    x = torch.tensor(_frames((3, 5, 33, 41, 3), 5))
    full = apply(None, x)
    for tile, ov in [((16, 16), 4), ((20, 12), 5), ((33, 16), 7)]:
        tiled = make_tiled_apply(apply, tile, ov, scale=2)(None, x)
        torch.testing.assert_close(tiled, full, rtol=1e-5, atol=1e-5)
    same = make_tiled_apply(apply, (64, 64), 8, scale=2)(None, x)
    assert torch.equal(same, full)


def test_tiled_apply_takes_the_config_forms():
    """eval.tile as an int is the square tile, and an overlap of None is
    TILE_OVERLAP (32): bitwise the explicit pair and overlap."""
    k1 = torch.tensor(_frames((8, 3, 3, 3), 3, 0.3))
    k2 = torch.tensor(_frames((3, 8, 3, 3), 4, 0.3))
    apply = _toy_apply(k1, k2)
    x = torch.tensor(_frames((1, 3, 70, 150, 3), 6))
    want = make_tiled_apply(apply, (66, 66), 32, scale=2)(None, x)
    assert torch.equal(make_tiled_apply(apply, 66, None, scale=2)(None, x), want)
    assert TILE_OVERLAP == 32


def test_tiled_apply_real_model_duf():
    """DUF-16L (receptive-field radius ~10) with 3 dense-1 layers, tiled
    28x28 with overlap 12 on a 32x36 frame (6 tiles), equals the whole
    frame within 2e-5."""
    torch.manual_seed(0)
    model = DUF(scale=4, dense1_layers=3).eval()
    x = torch.rand(1, 7, 32, 36, 3, generator=torch.Generator().manual_seed(1))
    apply = make_model_apply("DUF", 4)
    with torch.no_grad():
        full = apply(model, x)
        tiled = make_tiled_apply(apply, (28, 28), 12, scale=4)(model, x)
    assert tiled.shape == full.shape == (1, 128, 144, 3)
    torch.testing.assert_close(tiled, full, rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_edvr():
    """The port's tiny EDVR (offset convs off zero) and the same weights as
    JAX params, through the JAX package's `.pth` importer over a
    jax.eval_shape template (no compile)."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.convert.torch_import import convert_state_dict
    from dynavsr_tpu.models.edvr import EDVR as JaxEDVR

    torch.manual_seed(0)
    net = EDVR(**TINY)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
    vsr = JaxEDVR(**TINY)
    like = jax.eval_shape(vsr.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 12, 16, 3)))
    params = convert_state_dict({k: v.numpy() for k, v in net.state_dict().items()}, like)
    return vsr, params, net.eval()


def test_tiled_edvr_matches_jax(jax_edvr):
    """EDVR through the padded apply, tiled 12x16 with overlap 2 on 2
    windows of 22x30 (3 x 3 tiles, each mod-4 padded), against JAX's
    make_tiled_apply over its make_model_apply: 1e-4."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.eval.tiled import make_tiled_apply as jax_tiled_apply
    from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply

    vsr, params, net = jax_edvr
    x = np.random.default_rng(6).random((2, 3, 22, 30, 3)).astype(np.float32)
    want = jax.jit(jax_tiled_apply(jax_model_apply(vsr, "EDVR", 4), (12, 16), 2, 4))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = make_tiled_apply(make_model_apply("EDVR", 4), (12, 16), 2, 4)(
            net, torch.tensor(x))
        whole = make_model_apply("EDVR", 4)(net, torch.tensor(x))
    assert got.shape == (2, 88, 120, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float((got - whole).abs().max()) > 1e-4  # the tiles did run: EDVR is not tile-exact


def test_video_base_model_tiles_its_forward():
    """VideoBaseModel with eval.tile [12, 16] and eval.tile_overlap 2:
    make_infer_fn is make_tiled_apply over make_model_apply (bitwise), and
    there is no tiled sequence mode (make_seq_infer_fn None)."""
    net_g = {"which_model_G": "EDVR", **TINY}
    model = VideoBaseModel({"network_G": net_g, "eval": {"tile": [12, 16], "tile_overlap": 2}},
                           device="cpu")
    assert model.make_seq_infer_fn() is None
    assert VideoBaseModel({"network_G": net_g}, device="cpu").make_seq_infer_fn() is not None
    x = np.random.default_rng(7).random((2, 3, 22, 30, 3)).astype(np.float32)
    with torch.no_grad():
        want = make_tiled_apply(make_model_apply("EDVR", 4), (12, 16), 2, 4)(
            model.netG, torch.tensor(x)).numpy()
    np.testing.assert_array_equal(model.make_infer_fn()(x), want)


# ------------------------------------------------------------------ the CLIs
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One clip of 5 GT frames of 64x80 and LQ 16x20 (cv2's area
    downscale), and `.pth` files of a tiny EDVR (offset convs off zero) and
    an MFDN (nf 8, 3 frames)."""
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.models.downscaler import MFDN
    from dynavsr_tpu_torch.train.checkpoint import save_network

    root = tmp_path_factory.mktemp("tiled_cli")
    rng = np.random.default_rng(8)
    for sub in ("GT", "LQ"):
        (root / sub / "000").mkdir(parents=True)
    for i in range(5):
        base = rng.integers(0, 256, (16, 20, 3)).astype(np.float32)
        hr = cv2.resize(base, (80, 64), interpolation=cv2.INTER_CUBIC)
        hr = np.clip(hr + rng.normal(0.0, 4.0, hr.shape), 0, 255).round().astype(np.uint8)
        cv2.imwrite(str(root / "GT" / "000" / f"{i:08d}.png"), hr)
        cv2.imwrite(str(root / "LQ" / "000" / f"{i:08d}.png"),
                    cv2.resize(hr, (20, 16), interpolation=cv2.INTER_AREA))
    torch.manual_seed(0)
    edvr = EDVR(**TINY)
    with torch.no_grad():
        for name, p in edvr.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
            if name.startswith(("pcd_align.", "tsa_fusion.fea_fusion.", "HRconv.", "conv_last.")):
                p.mul_(3.0)
    save_network(str(root / "models"), 1, edvr)
    save_network(str(root / "models"), 1, MFDN(scale=4, nf=8, nframes=3), label="E")
    return root


YML = """
name: tiled_{cli}_{side}
model: video_base
scale: 4
datasets:
  test:
    name: reds
    mode: video_test
    dataroot_GT: {root}/GT
    dataroot_LQ: {root}/LQ
    N_frames: 3
    padding: reflection
network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}}
network_E: {{which_model_G: MFDN, nf: 8}}
path: {{root: {root}, pretrain_model_G: {root}/models/1_G.pth,
        pretrain_model_E: {root}/models/1_E.pth, strict_load: true}}
adapt: {{n_steps: 2, lr: !!float 1e-4, n_windows: 3, infer_chunk: 2, seq: true}}
eval: {{ycbcr: true, tile: [12, 16], tile_overlap: 2, seq: true, infer_chunk: 2}}
"""


@pytest.mark.parametrize("cli", ["test_dynavsr", "test"])
def test_cli_with_tiles_matches_jax(tree, cli):
    """cli.test_dynavsr.main (MFDN, 2 Adam steps; its 4x5 SLR windows pass
    through the tiled apply whole) and
    cli.test.main with eval.tile [12, 16], overlap 2 on 16x20 LR frames (4
    tiles), and `seq: true`, which tiling turns off in both packages: every
    saved SR frame within one uint8 level of the JAX CLI's, PSNR within
    0.01 dB, the adaptation losses within 1e-5 relative."""
    import importlib

    import cv2

    jax_cli = importlib.import_module(f"dynavsr_tpu.cli.{cli}")
    port_cli = importlib.import_module(f"dynavsr_tpu_torch.cli.{cli}")
    paths = {}
    for side in ("jax", "port"):
        paths[side] = tree / f"{cli}_{side}.yml"
        paths[side].write_text(textwrap.dedent(YML).format(root=tree, cli=cli, side=side))
    ref = jax_cli.main(["-opt", str(paths["jax"])])
    ours = port_cli.main(["-opt", str(paths["port"]), "--device", "cpu"])
    if cli == "test":
        ref, ours = ref["test"], ours["test"]
    assert abs(ours["000"]["psnr_avg"] - ref["000"]["psnr_avg"]) <= 0.01
    if cli == "test_dynavsr":
        np.testing.assert_allclose(ours["000"]["adapt_losses"], ref["000"]["adapt_losses"],
                                   rtol=1e-5)
    roots = {side: tree / "results" / f"tiled_{cli}_{side}" for side in paths}
    files = sorted(p.relative_to(roots["jax"]) for p in roots["jax"].rglob("*.png"))
    assert len(files) == 5
    assert files == sorted(p.relative_to(roots["port"]) for p in roots["port"].rglob("*.png"))
    for rel in files:
        a = cv2.imread(str(roots["jax"] / rel), cv2.IMREAD_UNCHANGED).astype(np.int16)
        b = cv2.imread(str(roots["port"] / rel), cv2.IMREAD_UNCHANGED).astype(np.int16)
        assert a.shape == b.shape == (64, 80, 3) and int(np.abs(a - b).max()) <= 1, rel
