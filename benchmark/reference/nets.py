"""Plain PyTorch reference of the networks the benchmark runs: EDVR (PCD
alignment with modulated deformable convs, TSA fusion, residual trunks,
x4 pixel-shuffle upsampling) and DynaVSR's MFDN downscaler, after the EDVR
paper (arXiv:1905.02716) and the DynaVSR paper (WACV 2021).

Functional: a network is a dict of named tensors (`Params`) whose names
are the published implementation's module attributes (conv_first,
pcd_align.L3_dcnpack.conv_offset_mask, tsa_fusion.tAtt_1, ...), so the
same tensors load into the program under test by name. Everything
computes in float32. `q` rounds the operands of every convolution and of
the deformable conv's contraction: `rounding("none")` is the reference
itself; "tf32" and "fp8" are the lower precisions of the correctness
control (benchmark/controls.py).

Imports torch and numpy only: no kernel, op or module of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str]]


# ---------------------------------------------------------------- precision
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (to nearest), kept in float32:
    what a TF32 tensor-core product does to its operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x in float8 e4m3 with one per-tensor scale (amax to 448), back in
    float32: an fp8 product's operands."""
    x = x.float()
    amax = x.abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient flowing back is rounded (straight
    through, so a second-order backward still differentiates it)."""

    @staticmethod
    def forward(ctx, y, fn):
        ctx.fn = fn
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g + (ctx.fn(g) - g).detach(), None


class Round:
    """A precision's rounding of a product's operands: `q(x)` rounds an
    operand (its gradient passes straight through) and `q.out(y)` rounds
    the gradient arriving at a product's output, the operand of its
    backward products. `fn` None is float32 itself."""

    def __init__(self, fn=None):
        self.fn = fn

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.fn is None else x + (self.fn(x) - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.fn is None else _GradRound.apply(y, self.fn)


def rounding(name: str) -> Round:
    """The products' rounding of a precision: none, tf32 or fp8."""
    return Round({"none": None, "tf32": _tf32, "fp8": _fp8}[name])


# ------------------------------------------------------------------- layers
def conv(p: Params, name: str, x: torch.Tensor, q: Round, stride: int = 1) -> torch.Tensor:
    w = p[name + ".weight"]
    return q.out(F.conv2d(q(x), q(w), p[name + ".bias"], stride, (w.shape[-1] - 1) // 2))


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def up2(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=s, mode="bilinear", align_corners=False)


def deform_conv(x, offset, mask, weight, bias, gd: int, q: Round) -> torch.Tensor:
    """Modulated deformable conv v2, 3x3, stride 1, padding 1:
    out(p) = b + sum_k w_k m_k(p) x(p + p_k + dp_k(p)), bilinear sampling in
    which a corner outside the frame contributes zero. offset (B, 2*Gd*9,
    H, W) holds (dy, dx) pairs per (group, tap), mask (B, Gd*9, H, W)."""
    b, c, h, w = x.shape
    k, cg = 9, c // gd
    dev = x.device
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, 1, h, 1)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, 1, w)
    ty = (torch.arange(k, device=dev) // 3 - 1).float().view(1, 1, k, 1, 1)
    tx = (torch.arange(k, device=dev) % 3 - 1).float().view(1, 1, k, 1, 1)
    off = offset.float().view(b, gd, k, 2, h, w)
    ys = gy + ty + off[:, :, :, 0]
    xs = gx + tx + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    planes = x.float().reshape(b, gd, cg, h * w)
    cols = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        wt = (ly if dy else 1 - ly) * (lx if dx else 1 - lx)
        wt = wt * ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).float()
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().view(b, gd, 1, -1)
        vals = torch.gather(planes, 3, idx.expand(b, gd, cg, idx.shape[-1]))
        cols = cols + vals.view(b, gd, cg, k, h, w) * wt.view(b, gd, 1, k, h, w)
    cols = cols * mask.float().view(b, gd, 1, k, h, w)
    cols = cols.reshape(b, c * k, h * w)
    wmat = weight.float().reshape(weight.shape[0], c * k)
    out = q.out(torch.matmul(q(wmat), q(cols))) + bias.view(1, -1, 1)
    return out.view(b, -1, h, w)


def _dcn(p: Params, name: str, x, offset_fea, gd: int, q: Round) -> torch.Tensor:
    om = conv(p, name + ".conv_offset_mask", offset_fea, q)
    n = 2 * gd * 9
    return deform_conv(x, om[:, :n], torch.sigmoid(om[:, n:]), p[name + ".weight"],
                       p[name + ".bias"], gd, q)


def _res(p: Params, name: str, x, q: Round) -> torch.Tensor:
    return x + conv(p, name + ".conv2", F.relu(conv(p, name + ".conv1", x, q)), q)


# --------------------------------------------------------------------- EDVR
def edvr_spec(nf: int, nframes: int, groups: int, front_RBs: int, back_RBs: int) -> Spec:
    """(name, shape, init kind) of every EDVR tensor (w_TSA, no predeblur,
    LR input)."""
    out: Spec = []

    def c(name, cin, cout, k=3, kind="conv"):
        out.append((name + ".weight", (cout, cin, k, k), kind))
        out.append((name + ".bias", (cout,), "bias"))

    def dcn(name):
        c(name + ".conv_offset_mask", nf, 3 * groups * 9, kind="offset")
        out.append((name + ".weight", (nf, nf, 3, 3), "relu"))
        out.append((name + ".bias", (nf,), "bias"))

    c("conv_first", 3, nf)
    for i in range(front_RBs):
        c(f"feature_extraction.{i}.conv1", nf, nf, kind="res")
        c(f"feature_extraction.{i}.conv2", nf, nf, kind="res")
    for n in ("fea_L2_conv1", "fea_L2_conv2", "fea_L3_conv1", "fea_L3_conv2"):
        c(n, nf, nf)
    a = "pcd_align."
    c(a + "L3_offset_conv1", 2 * nf, nf)
    c(a + "L3_offset_conv2", nf, nf)
    dcn(a + "L3_dcnpack")
    for lv in ("L2", "L1"):
        c(a + f"{lv}_offset_conv1", 2 * nf, nf)
        c(a + f"{lv}_offset_conv2", 2 * nf, nf)
        c(a + f"{lv}_offset_conv3", nf, nf)
        dcn(a + f"{lv}_dcnpack")
        c(a + f"{lv}_fea_conv", 2 * nf, nf)
    c(a + "cas_offset_conv1", 2 * nf, nf)
    c(a + "cas_offset_conv2", nf, nf)
    dcn(a + "cas_dcnpack")
    t = "tsa_fusion."
    c(t + "tAtt_1", nf, nf)
    c(t + "tAtt_2", nf, nf)
    c(t + "fea_fusion", nframes * nf, nf, 1)
    c(t + "sAtt_1", nframes * nf, nf, 1)
    c(t + "sAtt_2", 2 * nf, nf)
    c(t + "sAtt_3", nf, nf)
    c(t + "sAtt_4", nf, nf, 1)
    c(t + "sAtt_5", nf, nf)
    c(t + "sAtt_L1", nf, nf)
    c(t + "sAtt_L2", 2 * nf, nf)
    c(t + "sAtt_L3", nf, nf)
    c(t + "sAtt_add_1", nf, nf, 1)
    c(t + "sAtt_add_2", nf, nf, 1)
    for i in range(back_RBs):
        c(f"recon_trunk.{i}.conv1", nf, nf, kind="res")
        c(f"recon_trunk.{i}.conv2", nf, nf, kind="res")
    c("upconv1", nf, nf * 4)
    c("upconv2", nf, 64 * 4)
    c("HRconv", 64, 64)
    c("conv_last", 64, 3, kind="last")
    return out


def _pcd(p: Params, nbr, ref, gd: int, q: Round) -> torch.Tensor:
    a = "pcd_align."
    cat = torch.cat
    off = lrelu(conv(p, a + "L3_offset_conv1", cat([nbr[2], ref[2]], 1), q))
    off = lrelu(conv(p, a + "L3_offset_conv2", off, q))
    l3 = lrelu(_dcn(p, a + "L3_dcnpack", nbr[2], off, gd, q))
    l3_off = up2(off) * 2.0
    off = lrelu(conv(p, a + "L2_offset_conv1", cat([nbr[1], ref[1]], 1), q))
    off = lrelu(conv(p, a + "L2_offset_conv2", cat([off, l3_off], 1), q))
    off = lrelu(conv(p, a + "L2_offset_conv3", off, q))
    l2 = _dcn(p, a + "L2_dcnpack", nbr[1], off, gd, q)
    l2 = lrelu(conv(p, a + "L2_fea_conv", cat([l2, up2(l3)], 1), q))
    l2_off = up2(off) * 2.0
    off = lrelu(conv(p, a + "L1_offset_conv1", cat([nbr[0], ref[0]], 1), q))
    off = lrelu(conv(p, a + "L1_offset_conv2", cat([off, l2_off], 1), q))
    off = lrelu(conv(p, a + "L1_offset_conv3", off, q))
    l1 = _dcn(p, a + "L1_dcnpack", nbr[0], off, gd, q)
    l1 = conv(p, a + "L1_fea_conv", cat([l1, up2(l2)], 1), q)
    off = lrelu(conv(p, a + "cas_offset_conv1", cat([l1, ref[0]], 1), q))
    off = lrelu(conv(p, a + "cas_offset_conv2", off, q))
    return lrelu(_dcn(p, a + "cas_dcnpack", l1, off, gd, q))


def _tsa(p: Params, al: torch.Tensor, center: int, q: Round) -> torch.Tensor:
    t = "tsa_fusion."
    b, n, c, h, w = al.shape
    emb_ref = conv(p, t + "tAtt_2", al[:, center], q)
    emb = conv(p, t + "tAtt_1", al.reshape(b * n, c, h, w), q).reshape(b, n, -1, h, w)
    prob = torch.sigmoid((emb * emb_ref.unsqueeze(1)).sum(2)).unsqueeze(2)
    fea = lrelu(conv(p, t + "fea_fusion", (al * prob).reshape(b, n * c, h, w), q))

    def pools(v):
        return torch.cat([F.max_pool2d(v, 3, 2, 1), F.avg_pool2d(v, 3, 2, 1)], 1)

    att = lrelu(conv(p, t + "sAtt_1", al.reshape(b, n * c, h, w), q))
    att = lrelu(conv(p, t + "sAtt_2", pools(att), q))
    att_l = lrelu(conv(p, t + "sAtt_L1", att, q))
    att_l = lrelu(conv(p, t + "sAtt_L2", pools(att_l), q))
    att_l = up2(lrelu(conv(p, t + "sAtt_L3", att_l, q)))
    att = lrelu(conv(p, t + "sAtt_3", att, q)) + att_l
    att = up2(lrelu(conv(p, t + "sAtt_4", att, q)))
    att = conv(p, t + "sAtt_5", att, q)
    add = conv(p, t + "sAtt_add_2", lrelu(conv(p, t + "sAtt_add_1", att, q)), q)
    return fea * torch.sigmoid(att) * 2.0 + add


def pyramid(p: Params, frames: torch.Tensor, arch: dict, q: Round) -> List[torch.Tensor]:
    """frames (T, H, W, 3) -> per-frame features [L1, L2, L3] (T, nf, H /
    1, 2, 4, W / 1, 2, 4)."""
    f = frames.permute(0, 3, 1, 2).float()
    l1 = lrelu(conv(p, "conv_first", f, q))
    for i in range(arch["front_RBs"]):
        l1 = _res(p, f"feature_extraction.{i}", l1, q)
    l2 = lrelu(conv(p, "fea_L2_conv2", lrelu(conv(p, "fea_L2_conv1", l1, q, 2)), q))
    l3 = lrelu(conv(p, "fea_L3_conv2", lrelu(conv(p, "fea_L3_conv1", l2, q, 2)), q))
    return [l1, l2, l3]


def fuse(p: Params, levels, center_frames: torch.Tensor, arch: dict, q: Round) -> torch.Tensor:
    """Windows' features [(B, N, nf, h, w) per level] and their centre
    frames (B, H, W, 3) -> SR (B, 4H, 4W, 3): PCD, TSA, trunk, upsampling."""
    b, n, _, h, w = levels[0].shape
    center = n // 2
    nbr = [v.reshape(b * n, *v.shape[2:]) for v in levels]
    ref = [v[:, center].repeat_interleave(n, dim=0) for v in levels]
    al = _pcd(p, nbr, ref, arch["groups"], q).reshape(b, n, -1, h, w)
    out = _tsa(p, al, center, q)
    for i in range(arch["back_RBs"]):
        out = _res(p, f"recon_trunk.{i}", out, q)
    out = lrelu(F.pixel_shuffle(conv(p, "upconv1", out, q), 2))
    out = lrelu(F.pixel_shuffle(conv(p, "upconv2", out, q), 2))
    out = conv(p, "conv_last", lrelu(conv(p, "HRconv", out, q)), q)
    out = out + up2(center_frames.permute(0, 3, 1, 2).float(), 4)
    return out.permute(0, 2, 3, 1)


def edvr(p: Params, x: torch.Tensor, arch: dict, q: Round) -> torch.Tensor:
    """windows (B, N, H, W, 3), H and W multiples of 4 -> SR centre
    frames (B, 4H, 4W, 3)."""
    b, n, h, w, _ = x.shape
    levels = pyramid(p, x.reshape(b * n, h, w, 3), arch, q)
    levels = [v.reshape(b, n, *v.shape[1:]) for v in levels]
    return fuse(p, levels, x[:, n // 2], arch, q)


def edvr_padded(p: Params, x: torch.Tensor, arch: dict, q: Round) -> torch.Tensor:
    """EDVR over windows of any size: H and W reflection-padded at the
    bottom and right to multiples of 4, the SR cropped back."""
    b, n, h, w, _ = x.shape
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        flat = x.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
        flat = F.pad(flat, (0, pw, 0, ph), mode="reflect")
        x = flat.permute(0, 2, 3, 1).reshape(b, n, h + ph, w + pw, 3)
    return edvr(p, x, arch, q)[:, : 4 * h, : 4 * w]


# --------------------------------------------------------------------- MFDN
def mfdn_spec(nf: int, nframes: int, n_layers: int = 4) -> Spec:
    ch = 3 * nframes
    out: Spec = []
    for i in range(n_layers):
        out += [(f"body{i}.weight", (nf, ch if i == 0 else nf, 3, 3), "relu"),
                (f"body{i}.bias", (nf,), "bias")]
    for n in ("down", "refine0"):
        out += [(f"{n}.weight", (nf, nf, 3, 3), "relu"), (f"{n}.bias", (nf,), "bias")]
    out += [("out.weight", (ch, nf, 3, 3), "last"), ("out.bias", (ch,), "bias")]
    return out


def mfdn(p: Params, x: torch.Tensor, scale: int, q: Round, n_layers: int = 4) -> torch.Tensor:
    """MFDN: windows (B, T, H, W, 3) -> SLR windows (B, T, H/s, W/s, 3):
    convs over the frame-major (T*3)-channel stack, a stride-s conv, and a
    residual from the MATLAB-bicubic downscale."""
    b, t, h, w, c = x.shape
    base = imresize(x, 1.0 / scale)
    y = x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w).float()
    for i in range(n_layers):
        y = F.relu(conv(p, f"body{i}", y, q))
    y = F.relu(conv(p, "down", y, q, scale))
    y = F.relu(conv(p, "refine0", y, q))
    y = conv(p, "out", y, q)
    y = y.reshape(b, t, c, *y.shape[-2:]).permute(0, 1, 3, 4, 2)
    return y + base


# ----------------------------------------------------------- bicubic resize
def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1, 1.5 * ax ** 3 - 2.5 * ax ** 2 + 1,
                    np.where(ax <= 2, -0.5 * ax ** 3 + 2.5 * ax ** 2 - 4 * ax + 2, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of MATLAB's imresize along one axis:
    Keys cubic (a = -0.5), antialiased when shrinking, edge taps folded
    back by mirroring, rows normalised. Frozen from the arithmetic of the
    MATLAB-compatible resize in dynavsr_tpu_torch/data/resize.py
    (resize_weights), which copies the JAX package's."""
    scale = n_out / n_in
    width = 4.0 / scale if scale < 1 else 4.0
    u = np.arange(1, n_out + 1) / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - width / 2)
    taps = int(np.ceil(width)) + 2
    ind = left[:, None] + np.arange(taps)[None, :]
    wts = scale * _cubic((u[:, None] - ind) * scale) if scale < 1 else _cubic(u[:, None] - ind)
    wts = wts / wts.sum(1, keepdims=True)
    mirror = np.concatenate([np.arange(n_in), np.arange(n_in - 1, -1, -1)])
    cols = mirror[np.mod(ind.astype(np.int64) - 1, 2 * n_in)]
    mat = np.zeros((n_out, n_in))
    np.add.at(mat, (np.repeat(np.arange(n_out), taps), cols.ravel()), wts.ravel())
    return mat


def imresize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """MATLAB-bicubic resize of (..., H, W, C) by `scale`, in float32."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    mh = torch.as_tensor(resize_matrix(h, oh), dtype=torch.float32, device=x.device)
    mw = torch.as_tensor(resize_matrix(w, ow), dtype=torch.float32, device=x.device)
    y = x.float().movedim(-1, -3)
    return torch.matmul(torch.matmul(mh, y), mw.t()).movedim(-3, -1)
