"""EDVR: PCD alignment + TSA fusion + residual trunk (port of
dynavsr_tpu/models/edvr.py).

Attribute names are the reference's (conv_first, pcd_align.L3_dcnpack,
tsa_fusion.tAtt_1, ...), so a reference `.pth` loads with
`load_state_dict` and JAX params load through convert/from_jax.py.
Internally NCHW; `forward` and `forward_seq` keep the JAX package's NHWC
layout at their boundary: windows (B, N, H, W, 3) in, SR (B, 4H, 4W, 3)
fp32 out. With `dtype=torch.bfloat16` every conv and the DCN run in bf16
while the parameters stay fp32.

The reference's variants are all here: `predeblur` puts the pre-deblur
residual pyramid (and a 1x1 conv) in front of the feature trunk; `hr_in`
takes HR frames, brings them to a quarter of their size with two stride-2
convs (`conv_first_1/2/3`, or the pre-deblur's own), and adds the SR to
the centre HR frame itself instead of its x4 bilinear upsampling;
`w_TSA=False` fuses the aligned frames with one 1x1 conv (`tsa_fusion`)
over their frame-major concat instead of TSA.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from dynavsr_tpu_torch.models.arch_util import (
    ResidualBlockNoBN,
    ResTrunk,
    avg_pool_3x3_s2,
    conv,
    interpolate_bilinear,
    lrelu,
    max_pool_3x3_s2,
    variance_scaling_,
)
from dynavsr_tpu_torch.ops.dcn import deform_conv2d
from dynavsr_tpu_torch.ops.pixelshuffle import pixel_shuffle

__all__ = ["EDVR", "PCDAlign", "TSAFusion", "DCNSep", "PredeblurResNetPyramid"]

_TAPS = 9  # 3x3 kernel


class DCNSep(nn.Module):
    """EDVR's DCN_sep: offsets and mask come from a conv over a separate
    offset-feature input. conv_offset_mask emits 3*Gd*9 channels: the first
    2*Gd*9 are the (dy, dx)-interleaved offsets, the rest the pre-sigmoid
    mask. conv_offset_mask starts at zero like ModulatedDeformConvPack."""

    def __init__(self, nf: int, deformable_groups: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gd = deformable_groups
        self.conv_offset_mask = conv(nf, 3 * deformable_groups * _TAPS, dtype=dtype)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.weight = nn.Parameter(torch.empty(nf, nf, 3, 3))
        self.bias = nn.Parameter(torch.zeros(nf))
        variance_scaling_(self.weight, 2.0)

    def forward(self, x: torch.Tensor, offset_fea: torch.Tensor) -> torch.Tensor:
        om = self.conv_offset_mask(offset_fea)
        n_off = 2 * self.gd * _TAPS
        offset = om[:, :n_off].contiguous()
        mask = torch.sigmoid(om[:, n_off:]).contiguous()
        return deform_conv2d(x, offset, mask, self.weight.to(x.dtype),
                             self.bias.to(x.dtype), deformable_groups=self.gd)


class PCDAlign(nn.Module):
    """Pyramid-cascading-deformable alignment of one neighbour pyramid to
    the reference pyramid (lists of NCHW levels L1, L2, L3)."""

    def __init__(self, nf: int = 64, groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()

        def c(i, o):
            return conv(i, o, dtype=dtype)

        self.L3_offset_conv1 = c(nf * 2, nf)
        self.L3_offset_conv2 = c(nf, nf)
        self.L3_dcnpack = DCNSep(nf, groups, dtype)
        self.L2_offset_conv1 = c(nf * 2, nf)
        self.L2_offset_conv2 = c(nf * 2, nf)
        self.L2_offset_conv3 = c(nf, nf)
        self.L2_dcnpack = DCNSep(nf, groups, dtype)
        self.L2_fea_conv = c(nf * 2, nf)
        self.L1_offset_conv1 = c(nf * 2, nf)
        self.L1_offset_conv2 = c(nf * 2, nf)
        self.L1_offset_conv3 = c(nf, nf)
        self.L1_dcnpack = DCNSep(nf, groups, dtype)
        self.L1_fea_conv = c(nf * 2, nf)
        self.cas_offset_conv1 = c(nf * 2, nf)
        self.cas_offset_conv2 = c(nf, nf)
        self.cas_dcnpack = DCNSep(nf, groups, dtype)

    def forward(self, nbr: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> torch.Tensor:
        cat = torch.cat
        off = lrelu(self.L3_offset_conv1(cat([nbr[2], ref[2]], 1)))
        off = lrelu(self.L3_offset_conv2(off))
        l3_fea = lrelu(self.L3_dcnpack(nbr[2], off))
        l3_off_up = interpolate_bilinear(off, 2) * 2.0
        off = lrelu(self.L2_offset_conv1(cat([nbr[1], ref[1]], 1)))
        off = lrelu(self.L2_offset_conv2(cat([off, l3_off_up], 1)))
        off = lrelu(self.L2_offset_conv3(off))
        l2_fea = self.L2_dcnpack(nbr[1], off)
        l2_fea = lrelu(self.L2_fea_conv(cat([l2_fea, interpolate_bilinear(l3_fea, 2)], 1)))
        l2_off_up = interpolate_bilinear(off, 2) * 2.0
        off = lrelu(self.L1_offset_conv1(cat([nbr[0], ref[0]], 1)))
        off = lrelu(self.L1_offset_conv2(cat([off, l2_off_up], 1)))
        off = lrelu(self.L1_offset_conv3(off))
        l1_fea = self.L1_dcnpack(nbr[0], off)
        l1_fea = self.L1_fea_conv(cat([l1_fea, interpolate_bilinear(l2_fea, 2)], 1))
        off = lrelu(self.cas_offset_conv1(cat([l1_fea, ref[0]], 1)))
        off = lrelu(self.cas_offset_conv2(off))
        return lrelu(self.cas_dcnpack(l1_fea, off))


class TSAFusion(nn.Module):
    """Temporal-spatial attention fusion: (B, N, C, H, W) -> (B, C, H, W).
    The N*C channel stack is frame-major, like torch's view."""

    def __init__(self, nf: int = 64, nframes: int = 5, center: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.center = center

        def c(i, o, k=3):
            return conv(i, o, k, dtype=dtype)

        self.tAtt_1 = c(nf, nf)
        self.tAtt_2 = c(nf, nf)
        self.fea_fusion = c(nframes * nf, nf, 1)
        self.sAtt_1 = c(nframes * nf, nf, 1)
        self.sAtt_2 = c(nf * 2, nf)
        self.sAtt_3 = c(nf, nf)
        self.sAtt_4 = c(nf, nf, 1)
        self.sAtt_5 = c(nf, nf)
        self.sAtt_L1 = c(nf, nf)
        self.sAtt_L2 = c(nf * 2, nf)
        self.sAtt_L3 = c(nf, nf)
        self.sAtt_add_1 = c(nf, nf, 1)
        self.sAtt_add_2 = c(nf, nf, 1)

    def forward(self, aligned: torch.Tensor) -> torch.Tensor:
        b, n, c, h, w = aligned.shape
        emb_ref = self.tAtt_2(aligned[:, self.center])
        emb = self.tAtt_1(aligned.reshape(b * n, c, h, w)).reshape(b, n, -1, h, w)
        cor_prob = torch.sigmoid((emb * emb_ref.unsqueeze(1)).sum(2)).unsqueeze(2)
        fused = lrelu(self.fea_fusion((aligned * cor_prob).reshape(b, n * c, h, w)))

        att = lrelu(self.sAtt_1(aligned.reshape(b, n * c, h, w)))
        att = lrelu(self.sAtt_2(torch.cat([max_pool_3x3_s2(att), avg_pool_3x3_s2(att)], 1)))
        att_l = lrelu(self.sAtt_L1(att))
        att_l = lrelu(self.sAtt_L2(
            torch.cat([max_pool_3x3_s2(att_l), avg_pool_3x3_s2(att_l)], 1)))
        att_l = interpolate_bilinear(lrelu(self.sAtt_L3(att_l)), 2)
        att = lrelu(self.sAtt_3(att)) + att_l
        att = interpolate_bilinear(lrelu(self.sAtt_4(att)), 2)
        att = self.sAtt_5(att)
        att_add = self.sAtt_add_2(lrelu(self.sAtt_add_1(att)))
        return fused * torch.sigmoid(att) * 2.0 + att_add


class PredeblurResNetPyramid(nn.Module):
    """EDVR's pre-deblur module: a three-level pyramid of residual blocks
    over the (HR, with `hr_in`) input, fused back at L1 resolution."""

    def __init__(self, nf: int = 64, hr_in: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hr_in = hr_in
        if hr_in:
            self.conv_first_1 = conv(3, nf, dtype=dtype)
            self.conv_first_2 = conv(nf, nf, stride=2, dtype=dtype)
            self.conv_first_3 = conv(nf, nf, stride=2, dtype=dtype)
        else:
            self.conv_first = conv(3, nf, dtype=dtype)
        self.deblur_L2_conv = conv(nf, nf, stride=2, dtype=dtype)
        self.deblur_L3_conv = conv(nf, nf, stride=2, dtype=dtype)
        for name in ("RB_L3_1", "RB_L2_1", "RB_L2_2", *(f"RB_L1_{i}" for i in range(1, 6))):
            setattr(self, name, ResidualBlockNoBN(nf, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.hr_in:
            l1 = lrelu(self.conv_first_1(x))
            l1 = lrelu(self.conv_first_3(lrelu(self.conv_first_2(l1))))
        else:
            l1 = lrelu(self.conv_first(x))
        l2 = lrelu(self.deblur_L2_conv(l1))
        l3 = lrelu(self.deblur_L3_conv(l2))
        l3 = interpolate_bilinear(self.RB_L3_1(l3), 2)
        l2 = interpolate_bilinear(self.RB_L2_2(self.RB_L2_1(l2) + l3), 2)
        out = self.RB_L1_2(self.RB_L1_1(l1)) + l2
        return self.RB_L1_5(self.RB_L1_4(self.RB_L1_3(out)))


class EDVR(nn.Module):
    """EDVR x4. EDVR-M: nf=64, front_RBs=5, back_RBs=10.

    * ``forward(x)``: windows (B, N, H, W, 3) -> SR centre (B, 4H, 4W, 3).
    * ``extract_pyramid(frames)`` / ``fuse_pyramid(...)``: the two exact
      halves of ``forward`` (feature extraction is per frame).
    * ``forward_seq(frames, win_idx)``: each clip frame's pyramid computed
      once and shared by every sliding window that holds it (exact).
    """

    arch = "EDVR"  # its input convention (models/padding.py)

    def __init__(self, nf: int = 64, nframes: int = 5, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 10, center: Optional[int] = None,
                 predeblur: bool = False, hr_in: bool = False, w_TSA: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.center = center
        self.predeblur, self.hr_in, self.w_TSA = predeblur, hr_in, w_TSA
        if predeblur:
            self.pre_deblur = PredeblurResNetPyramid(nf, hr_in, dtype)
            self.conv_1x1 = conv(nf, nf, 1, dtype=dtype)
        elif hr_in:
            self.conv_first_1 = conv(3, nf, dtype=dtype)
            self.conv_first_2 = conv(nf, nf, stride=2, dtype=dtype)
            self.conv_first_3 = conv(nf, nf, stride=2, dtype=dtype)
        else:
            self.conv_first = conv(3, nf, dtype=dtype)
        self.feature_extraction = ResTrunk(nf, front_RBs, dtype)
        self.fea_L2_conv1 = conv(nf, nf, stride=2, dtype=dtype)
        self.fea_L2_conv2 = conv(nf, nf, dtype=dtype)
        self.fea_L3_conv1 = conv(nf, nf, stride=2, dtype=dtype)
        self.fea_L3_conv2 = conv(nf, nf, dtype=dtype)
        self.pcd_align = PCDAlign(nf, groups, dtype)
        if w_TSA:
            self.tsa_fusion = TSAFusion(
                nf, nframes, nframes // 2 if center is None else center, dtype)
        else:
            self.tsa_fusion = conv(nframes * nf, nf, 1, dtype=dtype)
        self.recon_trunk = ResTrunk(nf, back_RBs, dtype)
        self.upconv1 = conv(nf, nf * 4, dtype=dtype)
        self.upconv2 = conv(nf, 64 * 4, dtype=dtype)
        self.HRconv = conv(64, 64, dtype=dtype)
        self.conv_last = conv(64, 3, dtype=dtype)

    def extract_pyramid(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """frames (T, H, W, 3) NHWC -> [l1, l2, l3], NCHW at (T, nf, h, w),
        (T, nf, h/2, w/2), (T, nf, h/4, w/4); h, w = H, W, or H/4, W/4 with
        `hr_in`."""
        x = frames.permute(0, 3, 1, 2)
        if self.predeblur:
            l1 = self.conv_1x1(self.pre_deblur(x))
        elif self.hr_in:
            l1 = lrelu(self.conv_first_1(x))
            l1 = lrelu(self.conv_first_3(lrelu(self.conv_first_2(l1))))
        else:
            l1 = lrelu(self.conv_first(x))
        l1 = self.feature_extraction(l1)
        l2 = lrelu(self.fea_L2_conv2(lrelu(self.fea_L2_conv1(l1))))
        l3 = lrelu(self.fea_L3_conv2(lrelu(self.fea_L3_conv1(l2))))
        return [l1, l2, l3]

    def fuse_pyramid(self, l1: torch.Tensor, l2: torch.Tensor, l3: torch.Tensor,
                     x_center: torch.Tensor) -> torch.Tensor:
        """Per-window pyramids (B, N, nf, h[/2, /4], w[/2, /4]) and the raw
        centre frames (B, H, W, 3) -> SR (B, 4h, 4w, 3) fp32 (= (B, H, W, 3)
        with `hr_in`)."""
        b, n, _, h, w = l1.shape
        center = n // 2 if self.center is None else self.center
        # Neighbours folded into the batch (b-major), PCD run once.
        nbr = [f.reshape(b * n, *f.shape[2:]) for f in (l1, l2, l3)]
        ref = [f[:, center].repeat_interleave(n, dim=0) for f in (l1, l2, l3)]
        aligned = self.pcd_align(nbr, ref).reshape(b, n, -1, h, w)
        if self.w_TSA:
            fea = self.tsa_fusion(aligned)
        else:  # frame-major channel concat, like the reference's view
            fea = self.tsa_fusion(aligned.reshape(b, -1, h, w))
        out = self.recon_trunk(fea)
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.HRconv(out)))
        base = x_center.permute(0, 3, 1, 2)
        if not self.hr_in:
            base = interpolate_bilinear(base, 4)
        return (out + base).to(torch.float32).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h, w, c = x.shape
        center = n // 2 if self.center is None else self.center
        levels = self.extract_pyramid(x.reshape(b * n, h, w, c))
        l1, l2, l3 = [f.reshape(b, n, *f.shape[1:]) for f in levels]
        return self.fuse_pyramid(l1, l2, l3, x[:, center])

    def forward_seq(self, frames: torch.Tensor, win_idx: torch.Tensor) -> torch.Tensor:
        """frames (T, H, W, 3); win_idx (F, N) window indices
        (data/windows.all_windows) -> SR (F, 4H, 4W, 3) (HR frames in and
        (F, H, W, 3) out with `hr_in`)."""
        l1, l2, l3 = self.extract_pyramid(frames)
        center = win_idx.shape[1] // 2 if self.center is None else self.center
        return self.fuse_pyramid(l1[win_idx], l2[win_idx], l3[win_idx],
                                 frames[win_idx[:, center]])
