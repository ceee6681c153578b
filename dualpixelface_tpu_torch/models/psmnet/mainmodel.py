"""PSMNet with GwcNet's correlation volume, dual-pixel adapted (counterpart
of `dualpixelface_tpu/models/psmnet/mainmodel.py`).

The SPP tower (ResNet basic blocks to 1/4 resolution and four average-pool
branches) on each view, an integer-shift concat volume (`cost_volume`
"psmnet") or that volume with a group-wise correlation volume beside it
("gwcnet", `group_num` groups), the 3-hourglass aggregation of
`ops/aggregation`, and the plain soft-argmin over 4 * level bins at full
resolution. The JAX package's `agg_dpack` is an exact relayout of the same
aggregation; the key is accepted and has no counterpart here.

Inputs: batch["left"], batch["right"] [B, H, W, 3]. Outputs, n = 1 head in
eval mode and 3 in train mode: pred_depth [B, n, H, W]; prob_depth
[B, n, 4 * level, H, W]; ref_feature [B, H/4, W/4]. Modules are named after
the JAX variable tree (`weights.py` maps Flax's automatic names in order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.base import select_ref_target
from dualpixelface_tpu_torch.ops import cost_volume as cv
from dualpixelface_tpu_torch.ops.aggregation import PSMNetHGAggregation
from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d, ConvBN
from dualpixelface_tpu_torch.ops.resize import resize_linear


class BasicBlock(nn.Module):
    """ResNet basic block; `downsample`: a strided 1x1 conv + BatchNorm on
    the skip."""

    def __init__(self, in_ch: int, features: int, strides: int = 1, dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.convbn1 = ConvBN(in_ch, features, 3, strides, dilation=dilation)
        self.convbn2 = ConvBN(features, features, 3, 1, dilation=dilation)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, features, 1, strides, bias=False), BatchNorm2d(features)) if downsample else None

    def forward(self, x):
        out = self.convbn2(torch.relu(self.convbn1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _layer(in_ch, planes, blocks, strides, dilation, first_down) -> nn.ModuleList:
    return nn.ModuleList([BasicBlock(in_ch, planes, strides, dilation, downsample=first_down)]
                         + [BasicBlock(planes, planes, 1, dilation) for _ in range(1, blocks)])


class SPPFeatureExtraction(nn.Module):
    """[B, 3, H, W] -> [B, C, H/4, W/4]. The pools' windows follow the
    channel count (2C, C, C/2, C/4, floor windows), so the quarter-resolution
    features must be at least 2C on each axis."""

    def __init__(self, c: int, in_ch: int = 3):
        super().__init__()
        self.firstconv = nn.ModuleList([ConvBN(in_ch, c, 3, 2, 1), ConvBN(c, c, 3, 1, 1), ConvBN(c, c, 3, 1, 1)])
        self.layer1 = _layer(c, c, 3, 1, 1, False)
        self.layer2 = _layer(c, 2 * c, c // 2, 2, 1, True)  # c/2 blocks to 1/4
        self.layer3 = _layer(2 * c, 4 * c, 3, 1, 1, True)
        self.layer4 = _layer(4 * c, 4 * c, 3, 1, 2, False)  # dilated
        self.pools = (2 * c, c, c // 2, c // 4)
        self.branches = nn.ModuleList([ConvBN(4 * c, c, 1, 1, 0) for _ in self.pools])
        self.lastconv = ConvBN(10 * c, 4 * c, 3, 1, 1)
        self.classify = nn.Conv2d(4 * c, c, 1, bias=False)

    def forward(self, x):
        for convbn in self.firstconv:
            x = torch.relu(convbn(x))
        for block in self.layer1:
            x = block(x)
        for block in self.layer2:
            x = block(x)
        output_raw = x
        for block in (*self.layer3, *self.layer4):
            x = block(x)
        output_skip = x
        h, w = output_skip.shape[2:]
        branches = []
        for pool, convbn in zip(self.pools, self.branches):
            br = torch.relu(convbn(F.avg_pool2d(output_skip, pool, pool)))
            branches.append(resize_linear(br, (h, w), (2, 3), align_corners=True))
        feat = torch.cat([output_raw, output_skip] + branches[::-1], dim=1)
        return self.classify(torch.relu(self.lastconv(feat)))


@register_model("psmnet")
class PSMNET(nn.Module):
    def __init__(self, option):
        super().__init__()
        self.option = option
        opt = option.model
        c = int(opt.inplanes)
        self.volume = opt.cost_volume
        if self.volume not in ("psmnet", "gwcnet"):
            raise NotImplementedError(f"cost volume style {self.volume!r}")
        self.group_num = int(opt.group_num) if self.volume == "gwcnet" else 0
        self.costrange = cv.costrange(opt.mindisp, opt.maxdisp, opt.level)
        self.disparities = cv.regression_disparities(opt.mindisp, opt.maxdisp, opt.level, 4)
        self.feature_extraction = SPPFeatureExtraction(c, int(opt.get("input_channel", 3)))
        self.aggregation = PSMNetHGAggregation(c, in_ch=2 * c + self.group_num)

    def forward(self, batch: dict) -> dict:
        ref_img, tar_img = select_ref_target(batch, self.option)
        ref_fea = self.feature_extraction(torch.movedim(ref_img, -1, 1))
        tar_fea = self.feature_extraction(torch.movedim(tar_img, -1, 1))
        cost = cv.concat_volume_int(ref_fea, tar_fea, self.costrange)
        if self.volume == "gwcnet":
            cost = torch.cat([cost, cv.gwc_volume(ref_fea, tar_fea, self.costrange, self.group_num)], dim=1)
        cost_logits, _ = self.aggregation(cost)
        disps, probs = zip(*(cv.soft_argmin(logits, self.disparities) for logits in cost_logits))
        return {
            "pred_depth": torch.stack(disps, dim=1),
            "prob_depth": torch.stack(probs, dim=1),
            "ref_feature": torch.amax(ref_fea, dim=1),
        }
