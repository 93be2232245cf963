"""The port's entry points against the JAX package's on the same files, on
CPU: `cli.test.main` (plain evaluation) on a REDS-style clip tree and on a
Vimeo90K-T-style septuplet tree, and `cli.test_dynavsr.main` with an SFDN
estimator, each reading the same `.pth` checkpoints.

The checkpoints are the port's own state_dicts (train/checkpoint.
save_network) of a tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 residual
blocks; offset convs redrawn off zero so the DCNs sample off the grid, and
the alignment, fusion and last convs scaled up so the neighbours count) and
an SFDN (nf 8). The JAX CLIs read them through their own `.pth` importer
(convert/torch_import.py:convert_state_dict), which takes both networks'
keys. Each CLI saves its SR frames under its own results directory, and
every saved uint8 frame is the other side's within one level (fp32 SR that
differs by float noise can round to the neighbouring level), and per-clip
PSNR agrees within 0.01 dB. The LQ frames are downscaled from the GT
frames.
"""

import re
import textwrap

import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.models.downscaler import SFDN
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.train.checkpoint import save_network
from torch_one_thread import one_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

NET_G = "{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}"


def _write(root, layout, seed):
    """GT frames of 64x80 (noise drawn at 16x20 and upscaled bicubic, plus
    a little fine noise) and LQ frames of 16x20 area-downscaled from them."""
    rng = np.random.default_rng(seed)
    for clip, names in layout.items():
        for sub in ("GT", "LQ"):
            (root / sub / clip).mkdir(parents=True, exist_ok=True)
        for name in names:
            base = rng.integers(0, 256, (16, 20, 3)).astype(np.float32)
            hr = cv2.resize(base, (80, 64), interpolation=cv2.INTER_CUBIC)
            hr = np.clip(hr + rng.normal(0.0, 4.0, hr.shape), 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "GT" / clip / name), hr)
            cv2.imwrite(str(root / "LQ" / clip / name),
                        cv2.resize(hr, (20, 16), interpolation=cv2.INTER_AREA))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_parity")
    reds = {c: [f"{i:08d}.png" for i in range(t)] for c, t in (("000", 6), ("011", 5))}
    vimeo = {f"00001/000{q}": [f"im{i}.png" for i in range(1, 8)] for q in (1, 2, 3)}
    for seed, (name, layout) in enumerate((("reds", reds), ("vimeo", vimeo))):
        _write(root / name, layout, seed=seed)
    torch.manual_seed(0)
    edvr = EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
    with torch.no_grad():
        for name, p in edvr.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
            # At the init's scale a neighbour frame moves the SR by less than
            # one level, so a wrong window padding would not show; scaled
            # x3 here, a neighbour moves it by tens of levels.
            if name.startswith(("pcd_align.", "tsa_fusion.fea_fusion.", "HRconv.", "conv_last.")):
                p.mul_(3.0)
    sfdn = SFDN(nf=8)
    save_network(str(root / "models"), 1, edvr)
    save_network(str(root / "models"), 1, sfdn, label="E")
    return root


def _yml(work, name, body):
    path = work / f"{name}.yml"
    path.write_text(textwrap.dedent(body).format(root=work, net_g=NET_G))
    return str(path)


def _psnrs(results):
    return {k: v["psnr_avg"] for k, v in results.items()}


def _per_side(work, yml):
    """The config under a run name of its own for each CLI (so each saves
    its SR frames under its own results/<name>/): ((jax yml, its results
    root), (port yml, its results root))."""
    with open(yml) as f:
        text = f.read()
    name = re.search(r"^name: (\S+)$", text, re.M).group(1)
    sides = []
    for side in ("jax", "port"):
        path = yml.replace(".yml", f"_{side}.yml")
        with open(path, "w") as f:
            f.write(re.sub(r"^name: \S+$", f"name: {name}_{side}", text, count=1, flags=re.M))
        sides.append((path, work / "results" / f"{name}_{side}"))
    return sides


def _same_images(ref_root, our_root, n):
    """The n SR frames both CLIs saved: the same files, each pixel within
    one uint8 level."""
    ref = sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.png"))
    ours = sorted(p.relative_to(our_root) for p in our_root.rglob("*.png"))
    assert ours == ref and len(ref) == n
    for rel in ref:
        a = cv2.imread(str(ref_root / rel), cv2.IMREAD_UNCHANGED).astype(np.int16)
        b = cv2.imread(str(our_root / rel), cv2.IMREAD_UNCHANGED).astype(np.int16)
        assert a.shape == b.shape == (64, 80, 3), rel
        assert int(np.abs(a - b).max()) <= 1, rel


@pytest.mark.parametrize("kind", ["reds", "vimeo"])
def test_plain_eval_cli_matches_jax(work, kind):
    """cli.test.main on the same tree and `.pth`: every saved SR frame
    within one level of JAX's, and every clip (every septuplet's centre
    frame on Vimeo90K-T) and the average within 0.01 dB of JAX's,
    window-batched; eval.seq gives the same numbers on REDS
    within 1e-3 dB (the same math in other batch shapes, so an SR pixel
    may round to another uint8 level; JAX's own seq CLI test uses 1e-3)."""
    from dynavsr_tpu.cli import test as jax_cli
    from dynavsr_tpu_torch.cli import test as port_cli

    mode = "video_test" if kind == "reds" else "Vimeo90K_test"
    yml = _yml(work, f"eval_{kind}", f"""
        name: eval_{kind}
        model: video_base
        scale: 4
        datasets:
          test:
            name: {kind}
            mode: {mode}
            dataroot_GT: {{root}}/{kind}/GT
            dataroot_LQ: {{root}}/{kind}/LQ
            N_frames: 3
            padding: new_info
        network_G: {{net_g}}
        path: {{{{root: {{root}}, pretrain_model_G: {{root}}/models/1_G.pth, strict_load: true}}}}
        eval: {{{{ycbcr: {str(kind == "vimeo").lower()}}}}}
        """)
    (jax_yml, jax_out), (port_yml, port_out) = _per_side(work, yml)
    ref = jax_cli.main(["-opt", jax_yml])["test"]
    ours = port_cli.main(["-opt", port_yml, "--device", "cpu"])["test"]
    _same_images(jax_out, port_out, 11 if kind == "reds" else 3)
    assert set(ours) == set(ref) == ({"000", "011", "_avg"} if kind == "reds"
                                     else {"00001_0001", "00001_0002", "00001_0003", "_avg"})
    for clip, psnr in _psnrs(ref).items():
        assert abs(ours[clip]["psnr_avg"] - psnr) <= 0.01, clip
    if kind == "reds":
        seq_yml = yml.replace(".yml", "_seq.yml")
        with open(port_yml) as f, open(seq_yml, "w") as g:
            g.write(f.read().replace("ycbcr: false", "ycbcr: false, seq: true, infer_chunk: 4"))
        seq = port_cli.main(["-opt", seq_yml, "--no-save-images", "--device", "cpu"])["test"]
        for clip in ("000", "011"):
            assert abs(seq[clip]["psnr_avg"] - ours[clip]["psnr_avg"]) <= 1e-3


def test_dynavsr_cli_with_sfdn_matches_jax(work):
    """cli.test_dynavsr.main with network_E: SFDN, both checkpoints read
    from `.pth`: every saved SR frame within one level of JAX's, per-clip
    PSNR within 0.01 dB of JAX's, and the adaptation
    losses (2 Adam steps at lr 1e-4) within 1e-5 relative."""
    from dynavsr_tpu.cli import test_dynavsr as jax_cli
    from dynavsr_tpu_torch.cli import test_dynavsr as port_cli

    yml = _yml(work, "dynavsr_sfdn", """
        name: dynavsr_sfdn
        model: video_base
        scale: 4
        datasets:
          test:
            name: reds
            mode: video_test
            dataroot_GT: {root}/reds/GT
            dataroot_LQ: {root}/reds/LQ
            N_frames: 3
            padding: reflection
        network_G: {net_g}
        network_E: {{which_model_G: SFDN, nf: 8}}
        path: {{root: {root}, pretrain_model_G: {root}/models/1_G.pth,
                pretrain_model_E: {root}/models/1_E.pth, strict_load: true}}
        adapt: {{n_steps: 2, lr: !!float 1e-4, optimizer: adam, n_windows: 4, infer_chunk: 4}}
        eval: {{ycbcr: true}}
        """)
    (jax_yml, jax_out), (port_yml, port_out) = _per_side(work, yml)
    ref = jax_cli.main(["-opt", jax_yml])
    ours = port_cli.main(["-opt", port_yml, "--device", "cpu"])
    _same_images(jax_out, port_out, 11)
    assert set(ours) == set(ref) == {"000", "011", "_avg"}
    for clip, psnr in _psnrs(ref).items():
        assert abs(ours[clip]["psnr_avg"] - psnr) <= 0.01, clip
    for clip in ("000", "011"):
        np.testing.assert_allclose(ours[clip]["adapt_losses"], ref[clip]["adapt_losses"],
                                   rtol=1e-5)
