"""NNet, normal-assisted stereo, dual-pixel adapted (counterpart of
`dualpixelface_tpu/models/nnet/mainmodel.py`).

PSMNet's SPP tower on each view, the integer-shift concat volume, a flat
stack of 3-D residual filters (dres0-4), a classifier to one logit a plane,
a per-plane 2-D context refinement of those logits on [ref features |
logit] (all planes in one batched call), the plain soft-argmin of both
logit volumes after a x4 trilinear resize (align_corners=False), and with
`predict_normal` a normal module: the world-coordinate volume
(`grid_maker_3d`) beside the aggregated cost, pooled down the plane axis
to one plane, a dilated 2-D stack, a x4 bilinear resize (align_corners=True)
and an L2 normalisation.

Inputs: batch["left"], batch["right"] [B, H, W, 3], batch["K"] [B, 3, 3],
batch["abvalue"] [B, 2]. Outputs, in train and in eval mode: pred_depth
[B, 2, H, W] (the classifier's, then the refined); prob_depth
[B, 2, 4 * level, H, W]; pred_normal [B, 1, H, W, 3] or None;
ref_feature [B, H/4, W/4]. Modules are named after the JAX variable tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.base import select_ref_target
from dualpixelface_tpu_torch.models.psmnet.mainmodel import SPPFeatureExtraction
from dualpixelface_tpu_torch.models.stereodpnet.normal_module import _device_planes, grid_maker_3d
from dualpixelface_tpu_torch.ops import cost_volume as cv
from dualpixelface_tpu_torch.ops.blocks import ConvBN3D, LeakyReLU
from dualpixelface_tpu_torch.ops.resize import resize_linear

LEAKY = LeakyReLU(0.1)


class ConvtextStack(nn.ModuleList):
    """Dilated 3x3 convs without bias, each followed by a leaky ReLU of
    slope 0.1 (the last included). `plan`: (channels, dilation) a layer."""

    def __init__(self, in_ch: int, plan):
        chans = [in_ch] + [ch for ch, _ in plan]
        super().__init__([nn.Conv2d(chans[i], ch, 3, padding=dil, dilation=dil, bias=False)
                          for i, (ch, dil) in enumerate(plan)])

    def forward(self, x):
        for conv in self:
            x = LEAKY(conv(x))
        return x


class NNetNormalModule(nn.Module):
    def __init__(self, option, mindisp: float, maxdisp: float):
        super().__init__()
        opt = option.model
        c = int(opt.inplanes)
        self.costrange = cv.costrange(mindisp, maxdisp, opt.level)
        self.wc0_0 = ConvBN3D(3 + 2 * c, c, 3, 1, 1)
        self.wc0_1 = ConvBN3D(c, c, 3, 1, 1)
        # three stride-2 pools down the plane axis: D 8 -> 4 -> 2 -> 1
        for i in (1, 2, 3):
            setattr(self, f"pool{i}", ConvBN3D(c, c, (2, 3, 3), (2, 1, 1), (0, 1, 1)))
        self.n_convs = ConvtextStack(c, [(3 * c, 1), (3 * c, 2), (3 * c, 4), (2 * c, 8), (2 * c, 16), (c, 1), (3, 1)])

    def forward(self, cost_in, batch):
        """cost_in [B, 2C, D, h, w] -> normal map [B, H, W, 3]."""
        b, _, d, h, w = cost_in.shape
        planes = _device_planes(tuple(np.asarray(self.costrange, np.float32).tolist()), cost_in.device)
        disp_range = planes.reshape(1, -1, 1, 1).expand(b, d, h, w)
        wc = torch.movedim(grid_maker_3d(batch["K"], disp_range, batch.get("abvalue")), -1, 1)
        y = torch.cat([wc.to(cost_in.dtype), cost_in], dim=1)
        for name in ("wc0_0", "wc0_1", "pool1", "pool2", "pool3"):
            y = torch.relu(getattr(self, name)(y))
        c, dd = y.shape[1], y.shape[2]
        feats = torch.movedim(y, 2, 1).reshape(b * dd, c, h, w)
        nmap = self.n_convs(feats).reshape(b, dd, 3, h, w).sum(dim=1)
        nmap = resize_linear(nmap, (4 * h, 4 * w), (2, 3), align_corners=True)
        nmap = torch.movedim(nmap, 1, -1)  # [B, H, W, 3]
        return nmap / torch.clamp_min(torch.linalg.vector_norm(nmap, dim=-1, keepdim=True), 1e-12)


@register_model("nnet")
class NNET(nn.Module):
    def __init__(self, option):
        super().__init__()
        self.option = option
        opt = option.model
        c = int(opt.inplanes)
        self.costrange = cv.costrange(opt.mindisp, opt.maxdisp, opt.level)
        self.disparities = cv.regression_disparities(opt.mindisp, opt.maxdisp, opt.level, 4)
        self.feature_extraction = SPPFeatureExtraction(c, int(opt.get("input_channel", 3)))
        self.dres0_0 = ConvBN3D(2 * c, c, 3, 1, 1)
        self.dres0_1 = ConvBN3D(c, c, 3, 1, 1)
        for i in (1, 2, 3, 4):
            setattr(self, f"dres{i}_0", ConvBN3D(c, c, 3, 1, 1))
            setattr(self, f"dres{i}_1", ConvBN3D(c, c, 3, 1, 1))
        self.classify_0 = ConvBN3D(c, c, 3, 1, 1)
        self.classify_1 = nn.Conv3d(c, 1, 3, 1, 1, bias=False)
        self.convs = ConvtextStack(c + 1, [(4 * c, 1), (4 * c, 2), (4 * c, 4), (3 * c, 8), (2 * c, 16), (c, 1), (1, 1)])
        self.normal_module = NNetNormalModule(option, opt.mindisp, opt.maxdisp) if opt.predict_normal else None

    def forward(self, batch: dict) -> dict:
        ref_img, tar_img = select_ref_target(batch, self.option)
        ref_fea = self.feature_extraction(torch.movedim(ref_img, -1, 1))  # [B, C, h, w]
        tar_fea = self.feature_extraction(torch.movedim(tar_img, -1, 1))
        cost = cv.concat_volume_int(ref_fea, tar_fea, self.costrange)  # [B, 2C, D, h, w]

        cost0 = torch.relu(self.dres0_1(torch.relu(self.dres0_0(cost))))
        cost_in0 = cost0
        for i in (1, 2, 3, 4):
            cost0 = getattr(self, f"dres{i}_1")(torch.relu(getattr(self, f"dres{i}_0")(cost0))) + cost0
        costs = self.classify_1(torch.relu(self.classify_0(cost0)))[:, 0]  # [B, D, h, w]

        # the per-plane 2-D refinement, the planes folded into the batch
        b, d, h, w = costs.shape
        ref_tiled = ref_fea[:, None].expand(b, d, *ref_fea.shape[1:])
        slices_in = torch.cat([ref_tiled, costs[:, :, None]], dim=2).reshape(b * d, -1, h, w)
        costss = self.convs(slices_in).reshape(b, d, h, w) + costs

        disps, probs = [], []
        for logits in (costs, costss):
            up = resize_linear(logits, (4 * d, 4 * h, 4 * w), (1, 2, 3), align_corners=False)
            disp, prob = cv.soft_argmin(up, self.disparities)
            disps.append(disp)
            probs.append(prob)

        normal = None
        if self.normal_module is not None:
            normal = self.normal_module(torch.cat([cost_in0, cost0], dim=1), batch)[:, None]
        return {
            "pred_depth": torch.stack(disps, dim=1),
            "prob_depth": torch.stack(probs, dim=1),
            "pred_normal": normal,
            "ref_feature": torch.amax(ref_fea, dim=1),
        }
