"""PSMNet hourglass 3-D cost aggregation (counterpart of
`dualpixelface_tpu/ops/aggregation.py`).

Channels-first [B, C, D, H, W] with plain cuDNN 3-D convolutions; the JAX
package's D-packed layouts (`agg_dpack`) and dslice folds (`agg_dfold`) are
exact relayouts of this same math and have no counterpart here. Attribute
names follow the reference torch `state_dict`.
"""
from __future__ import annotations

import torch
from torch import nn

from dualpixelface_tpu_torch.ops.blocks import ConvBN3D, TConvBN3D
from dualpixelface_tpu_torch.ops.resize import resize_linear


class PSMNetHourglass(nn.Module):
    """Encoder-decoder over (D, H, W) with skip fusion."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBN3D(c, 2 * c, 3, 2, 1), nn.ReLU())
        self.conv2 = ConvBN3D(2 * c, 2 * c, 3, 1, 1)
        self.conv3 = nn.Sequential(ConvBN3D(2 * c, 2 * c, 3, 2, 1), nn.ReLU())
        self.conv4 = nn.Sequential(ConvBN3D(2 * c, 2 * c, 3, 1, 1), nn.ReLU())
        self.conv5 = TConvBN3D(2 * c, 2 * c)
        self.conv6 = TConvBN3D(2 * c, c)

    def forward(self, x, presqu, postsqu):
        out = self.conv1(x)
        pre = self.conv2(out)
        pre = torch.relu(pre + postsqu) if postsqu is not None else torch.relu(pre)
        out = self.conv4(self.conv3(pre))
        up1 = self.conv5(out)
        post = torch.relu(up1 + presqu) if presqu is not None else torch.relu(up1 + pre)
        return self.conv6(post), pre, post


class PSMNetHGAggregation(nn.Module):
    """Pre-filters + 3 hourglasses + 3 cascaded classifier heads.

    Input [B, in_ch, D, H, W], in_ch 2C unless given (PSMNet's gwcnet
    volume adds its G group channels). Returns (logits, feature volumes), one entry per
    head: in eval mode the last head only, ([cost3], [out3]); in train mode
    all three, ([cost3, cost2, cost1], [out3, out2, out1]), as the JAX
    package returns them. The logits are [B, 4D, 4H, 4W] (x4 align-corners
    trilinear) or, with `upsample=False`, the coarse [B, D, H, W] for the
    fused soft-argmin; the feature volumes are the pre-classifier
    [B, C, D, H, W].
    """

    def __init__(self, c: int, upsample: bool = True, in_ch: int | None = None):
        super().__init__()
        self.upsample = upsample
        self.dres0 = nn.Sequential(
            ConvBN3D(2 * c if in_ch is None else in_ch, c, 3, 1, 1), nn.ReLU(), ConvBN3D(c, c, 3, 1, 1), nn.ReLU()
        )
        self.dres1 = nn.Sequential(ConvBN3D(c, c, 3, 1, 1), nn.ReLU(), ConvBN3D(c, c, 3, 1, 1))
        self.dres2 = PSMNetHourglass(c)
        self.dres3 = PSMNetHourglass(c)
        self.dres4 = PSMNetHourglass(c)
        for i in (1, 2, 3):
            setattr(self, f"classif{i}", nn.Sequential(
                ConvBN3D(c, c, 3, 1, 1), nn.ReLU(), nn.Conv3d(c, 1, 3, 1, 1, bias=False)
            ))

    def forward(self, cost):
        cost0 = self.dres0(cost)
        cost0 = self.dres1(cost0) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0

        cost1 = self.classif1(out1)
        cost2 = self.classif2(out2) + cost1
        cost3 = self.classif3(out3) + cost2
        def up(cc):
            logits = cc[:, 0]  # [B, D, H, W]
            if self.upsample:
                d, h, w = logits.shape[1:]
                logits = resize_linear(logits, (4 * d, 4 * h, 4 * w), (1, 2, 3))
            return logits

        if self.training:
            return [up(cost3), up(cost2), up(cost1)], [out3, out2, out1]
        return [up(cost3)], [out3]
