"""StereoNet, dual-pixel adapted (counterpart of
`dualpixelface_tpu/models/stereonet/mainmodel.py`).

k stride-2 5x5 convs and 6 residual blocks to 1/2^k resolution (each view
through the tower on its own, as in JAX), a subtraction cost volume over
2^k planes along the dual-pixel (H) axis, four 3-D filters and a 3-D conv to
one logit a plane, the plain soft-argmin, and one edge-aware refinement
guided by the full-resolution right image.

Inputs: batch["left"], batch["right"] [B, H, W, 3]. Outputs, in train and
in eval mode: pred_depth [B, 2, H, W] (the coarse disparity resized to full
resolution, then the refined one); prob_depth [B, 1, 2^k, H/2^k, W/2^k];
ref_feature [B, H/2^k, W/2^k]. Modules are named after the JAX variable
tree (`weights.py` maps Flax's automatic names in order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.base import select_ref_target
from dualpixelface_tpu_torch.ops import cost_volume as cv
from dualpixelface_tpu_torch.ops.blocks import ConvBN, ConvBN3D, LeakyReLU
from dualpixelface_tpu_torch.ops.resize import resize_linear

SLOPE = 0.2


class ResidualBlock(nn.Module):
    """ConvBN + leaky ReLU with an identity skip."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        self.convbn = ConvBN(features, features, 3, 1, dilation=dilation)
        self.act = LeakyReLU(SLOPE)

    def forward(self, x):
        return x + self.act(self.convbn(x))


class FeatureExtraction(nn.Module):
    """k stride-2 5x5 convs (with bias) to 1/2^k resolution, 6 residual
    blocks, a 3x3 conv (with bias). [B, 3, H, W] -> [B, 32, H/2^k, W/2^k]."""

    def __init__(self, k: int, in_ch: int = 3):
        super().__init__()
        self.downsample = nn.ModuleList(
            [nn.Conv2d(in_ch if i == 0 else 32, 32, 5, 2, 2) for i in range(k)])
        self.blocks = nn.ModuleList([ResidualBlock(32) for _ in range(6)])
        self.lastconv = nn.Conv2d(32, 32, 3, 1, 1)

    def forward(self, x):
        for conv in self.downsample:
            x = conv(x)
        for block in self.blocks:
            x = block(x)
        return self.lastconv(x)


class EdgeAwareRefinement(nn.Module):
    """Dilated residual refinement of the low-resolution disparity on the
    guidance image."""

    def __init__(self):
        super().__init__()
        self.convbn = ConvBN(4, 32, 3, 1)
        self.act = LeakyReLU(SLOPE)
        self.blocks = nn.ModuleList([ResidualBlock(32, dilation=d) for d in (1, 2, 4, 8, 1, 1)])
        self.lastconv = nn.Conv2d(32, 1, 3, 1, 1)

    def forward(self, low_disparity, rgb):
        """low_disparity [B, h, w], rgb [B, 3, H, W] -> [B, H, W]."""
        w_low = low_disparity.shape[-1]
        H, W = rgb.shape[2:]
        twice = resize_linear(low_disparity[:, None], (H, W), (2, 3), align_corners=False)
        if W / w_low >= 1.5:
            twice = twice * 8.0  # a literal 8, not the ratio, as in JAX
        out = self.act(self.convbn(torch.cat([twice, rgb], dim=1)))
        for block in self.blocks:
            out = block(out)
        return F.relu(twice + self.lastconv(out))[:, 0]


@register_model("stereonet")
class STEREONET(nn.Module):
    def __init__(self, option):
        super().__init__()
        self.option = option
        opt = option.model
        level = 2 ** int(opt.k)
        self.costrange = cv.costrange(opt.mindisp, opt.maxdisp, level)
        self.disparities = cv.regression_disparities(opt.mindisp, opt.maxdisp, level, 1)
        self.feature_extraction = FeatureExtraction(int(opt.k), int(opt.get("input_channel", 3)))
        for i in range(4):
            setattr(self, f"filter{i}", ConvBN3D(32, 32, 3, 1, 1))
        self.conv3d_alone = nn.Conv3d(32, 1, 3, 1, 1)
        self.refinement = EdgeAwareRefinement()
        self.act = LeakyReLU(SLOPE)

    def forward(self, batch: dict) -> dict:
        ref_img, tar_img = select_ref_target(batch, self.option)
        ref_fea = self.feature_extraction(torch.movedim(ref_img, -1, 1))
        tar_fea = self.feature_extraction(torch.movedim(tar_img, -1, 1))

        costv = cv.subtraction_volume(ref_fea, tar_fea, self.costrange)  # [B, C, D, h, w]
        for i in range(4):
            costv = self.act(getattr(self, f"filter{i}")(costv))
        costv = self.conv3d_alone(costv)[:, 0]  # [B, D, h, w]
        disp_low, prob = cv.soft_argmin(costv, self.disparities)

        guidance = torch.movedim(batch["right"], -1, 1)
        refined = self.refinement(disp_low, guidance)
        H, W = guidance.shape[2:]
        coarse = disp_low * (W / disp_low.shape[-1])
        coarse = resize_linear(coarse, (H, W), (1, 2), align_corners=False)
        return {
            "pred_depth": torch.stack([coarse, refined], dim=1),
            "prob_depth": prob[:, None],
            "ref_feature": torch.amax(ref_fea, dim=1),
        }
