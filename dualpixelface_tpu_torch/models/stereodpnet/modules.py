"""StereoDPNet building blocks: DPBlock FPN feature extractor and the ASM
cost volume (counterpart of `dualpixelface_tpu/models/stereodpnet/modules.py`).

Channels-first [B, C, H, W] throughout; the cost volume is
[B, 2C, D, H, W]. Attribute names follow the reference torch `state_dict`.
The JAX package's `tower_s2d` space-to-depth layout is an exact relayout of
these convolutions and has no counterpart here.
"""
from __future__ import annotations

import torch
from torch import nn

from dualpixelface_tpu_torch.ops.asm import MaskingAttention, subpixel_shift_planes
from dualpixelface_tpu_torch.ops.blocks import ConvBN, DepthwiseSeparableConv, PReLU
from dualpixelface_tpu_torch.ops.cost_volume import costrange as make_costrange
from dualpixelface_tpu_torch.ops.resize import resize_linear, resize_nearest


class DPBlock(nn.Module):
    """Dual conv + 3-way dilated (1/3/5) parallel convs + PReLU skips +
    strided dilated conv4 + depthwise-separable conv5 + 1x1 strided skip."""

    def __init__(self, in_ch: int, features: int, ratio_s: int, ratio_t: int, reluw: float = 0.05):
        super().__init__()
        c = features
        self.conv1 = nn.Sequential(ConvBN(in_ch, c, 3, 1, 1, 1), PReLU(reluw))
        self.conv2 = nn.Sequential(ConvBN(c, c, 3, 1, 1, 1), PReLU(reluw))
        self.conv_dilate = nn.ModuleList(
            [ConvBN(c, c, 3, 1, dilation=2 * i + 1) for i in range(3)]
        )
        self.conv3 = ConvBN(3 * c, c, 3, 1, 1, 1)
        self.prelu = PReLU(reluw)
        self.conv4 = nn.Sequential(ConvBN(c, ratio_t * c, 3, ratio_s, dilation=2), PReLU(reluw))
        self.conv5 = DepthwiseSeparableConv(ratio_t * c, ratio_t * c, 3, 1)
        self.conv_skip = nn.Conv2d(in_ch, ratio_t * c, 1, ratio_s, bias=True)

    def forward(self, x):
        out1 = self.conv1(x)
        out2 = self.conv2(out1)
        out2 = self.conv3(torch.cat([conv(out2) for conv in self.conv_dilate], dim=1))
        out = self.prelu(out2 + out1)
        out = self.conv5(self.conv4(out))
        return out + self.conv_skip(x)


class FPN(nn.Module):
    """Feature pyramid fusion: 1x1 laterals, nearest top-down adds, 3x3
    output convs (torchvision FeaturePyramidNetwork semantics)."""

    def __init__(self, in_channels, features: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList([nn.Conv2d(c, features, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList([nn.Conv2d(features, features, 3, padding=1) for _ in in_channels])

    def forward(self, levels):
        laterals = [conv(x) for conv, x in zip(self.inner_blocks, levels)]
        fused = [None] * len(laterals)
        fused[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            up = resize_nearest(fused[i + 1], laterals[i].shape[2:4], (2, 3))
            fused[i] = laterals[i] + up
        return [conv(x) for conv, x in zip(self.layer_blocks, fused)]


class FeatureExtraction(nn.Module):
    """Stride-2 stem, DPBlock stages at 1/4, 1/8, 1/16, FPN fused back to
    1/4, concat of the three scales, lastconv. [B, 3, H, W] -> [B, C, H/4, W/4]."""

    def __init__(self, option):
        super().__init__()
        opt = option.model
        c = opt.inplanes
        stack = opt.block_stack
        cin = opt.get("input_channel", 3)
        self.firstconv = nn.Sequential(
            ConvBN(cin, c, 3, 2, 1, 1), nn.ReLU(),
            ConvBN(c, c, 3, 1, 1, 1), nn.ReLU(),
            ConvBN(c, c, 3, 1, 1, 1), nn.ReLU(),
        )
        self.block1 = DPBlock(c, c, 2, 1)
        self.interblock1 = nn.ModuleList([DPBlock(c, c, 1, 1) for _ in range(stack)])
        self.block2 = DPBlock(c, c, 2, 2)
        self.interblock2 = nn.ModuleList([DPBlock(2 * c, 2 * c, 1, 1) for _ in range(stack)])
        self.block3 = DPBlock(2 * c, 2 * c, 2, 2)
        self.fpn = FPN((c, 2 * c, 4 * c), c)
        self.lastconv = nn.Sequential(
            ConvBN(3 * c, 2 * c, 3, 1, 1, 1), nn.ReLU(),
            ConvBN(2 * c, c, 3, 1, 1, 1), nn.ReLU(),
        )

    def forward(self, x):
        out1 = self.block1(self.firstconv(x))  # 1/4, C
        out2 = out1
        for blk in self.interblock1:
            out2 = blk(out2)
        out2 = self.block2(out2)  # 1/8, 2C
        out3 = out2
        for blk in self.interblock2:
            out3 = blk(out3)
        out3 = self.block3(out3)  # 1/16, 4C
        high, mid, low = self.fpn([out1, out2, out3])
        stage1 = resize_linear(mid, (2 * mid.shape[2], 2 * mid.shape[3]), (2, 3))
        stage2 = resize_linear(low, (4 * low.shape[2], 4 * low.shape[3]), (2, 3))
        return self.lastconv(torch.cat([high, stage1, stage2], dim=1))


class ASMCostVolume(nn.Module):
    """Sub-pixel shifted concat cost volume with shared masking attention:
    [B, C, H, W] x 2 -> [B, 2C, D, H, W]. `fast_attention` selects the
    hoisted-head attention, else the exact one. `compat_nearest` takes the
    reference's stretched nearest grid; `compat_frozen_shift_grid` shifts
    every plane by costrange[0], as the reference's sampling grid, cached on
    its first call, does. The JAX package's attention layouts
    (`attention_layout`, `fast_attention_layout`, `asm_head_s2d`,
    `asm_remat_save`) are relayouts of the same math; their keys are
    accepted and have no effect here."""

    def __init__(self, option, mindisp: float, maxdisp: float):
        super().__init__()
        opt = option.model
        disps = tuple(make_costrange(mindisp, maxdisp, opt.level).tolist())
        if opt.get("compat_frozen_shift_grid", False):
            disps = (disps[0],) * len(disps)
        self.disps = disps
        self.modes = dict(nearest=opt.nearest, bilinear=opt.bilinear, phase=opt.phase,
                          compat_nearest=bool(opt.get("compat_nearest", False)))
        self.fast = bool(opt.get("fast_attention", False))
        self.attention_layer = MaskingAttention(
            opt.inplanes, act=opt.asm_activation, feature_fetch=opt.feature_fetch
        )

    def _shift(self, direction):
        return lambda t: subpixel_shift_planes(t, self.disps, direction, axis=2, **self.modes)

    def forward(self, ref_feat, tar_feat):
        attend = self.attention_layer.forward_fast if self.fast else self.attention_layer
        vol_ref = attend(ref_feat, self._shift("forward"))
        vol_tar = attend(tar_feat, self._shift("backward"))
        return torch.cat([vol_ref, vol_tar], dim=1)
