"""BTS, monocular depth with local planar guidance from the dual-pixel
center image (counterpart of `dualpixelface_tpu/models/bts/mainmodel.py`).

A backbone (`encoder.py`) and the BTS decoder: nearest-upsample ELU
upconvs, the dense ASPP chain (dilations 3/6/12/18/24), `Reduction1x1`
plane heads (theta, phi, distance -> a plane), `local_planar_guidance` at
x8/x4/x2, and a sigmoid depth scaled to [min_depth, max_depth]. It trains
with silog on target_type "depth". The decoder's BatchNorms run at Flax's
momentum 0.99 (torch's 0.01) and eps 1.1e-5; its convs are xavier-uniform,
the encoder's He-normal with fan_out, as in JAX.

Inputs: batch["center"] [B, H, W, 3], H and W multiples of 32. Outputs, in
train and in eval mode: pred_depth [B, 1, H, W], in the depth's units
(millimetres for FaceDP); ref_feature [B, H/2, W/2], the channel max of the
encoder's first skip. The encoder carries torchvision's names, the decoder
the JAX tree's (`weights.py` maps Flax's automatic names in call order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.bts.encoder import make_encoder
from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d
from dualpixelface_tpu_torch.ops.resize import downsample2d_nearest, upsample2d_nearest

CF = (2, 3)  # the spatial axes of [B, C, H, W]


def bts_bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1.1e-5, momentum=0.01)


def conv3x3(in_ch: int, features: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, features, 3, 1, dilation, dilation, bias=False)


class Upconv(nn.Module):
    """Nearest x2, a 3x3 conv, ELU."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = conv3x3(in_ch, features)

    def forward(self, x):
        return F.elu(self.conv(upsample2d_nearest(x, 2, CF)))


class AtrousConv(nn.Module):
    """(BatchNorm) -> ReLU -> 1x1 conv to 2C -> BatchNorm -> ReLU -> dilated
    3x3 conv to C."""

    def __init__(self, in_ch: int, features: int, dilation: int, apply_bn_first: bool = True):
        super().__init__()
        self.first_bn = bts_bn(in_ch) if apply_bn_first else None
        self.reduce = nn.Conv2d(in_ch, 2 * features, 1, bias=False)
        self.mid_bn = bts_bn(2 * features)
        self.dilated = conv3x3(2 * features, features, dilation)

    def forward(self, x):
        if self.first_bn is not None:
            x = self.first_bn(x)
        x = torch.relu(self.mid_bn(self.reduce(torch.relu(x))))
        return self.dilated(x)


class Reduction1x1(nn.Module):
    """1x1 + ELU reductions, halving from `num_out_filters` while it is at
    least 8, then a 1x1 head: 3 channels to the plane (n1, n2, n3, dist)
    [B, 4, h, w], or with `is_final` 1 channel to a sigmoid [B, 1, h, w].
    Below 4 filters no conv runs and the input's first three channels give
    the plane (bts_size 64's `reduc1x1`: its 4-channel plane stack)."""

    def __init__(self, in_ch: int, num_out_filters: int, max_depth: float, is_final: bool = False):
        super().__init__()
        self.max_depth = max_depth
        self.is_final = is_final
        self.head = False
        convs = []
        nf = num_out_filters
        while nf >= 4:
            if nf < 8:
                convs.append(nn.Conv2d(in_ch, 1 if is_final else 3, 1, bias=False))
                self.head = True
                break
            convs.append(nn.Conv2d(in_ch, nf, 1, bias=False))
            in_ch, nf = nf, nf // 2
        self.convs = nn.ModuleList(convs)
        self.out_channels = 1 if self.head and is_final else 4

    def forward(self, x):
        n = len(self.convs) - int(self.head)
        for conv in self.convs[:n]:
            x = F.elu(conv(x))
        if self.head:
            x = self.convs[-1](x)
            if self.is_final:
                return torch.sigmoid(x)
        theta = torch.sigmoid(x[:, 0]) * math.pi / 3
        phi = torch.sigmoid(x[:, 1]) * math.pi * 2
        dist = torch.sigmoid(x[:, 2]) * self.max_depth
        n1 = torch.sin(theta) * torch.cos(phi)
        n2 = torch.sin(theta) * torch.sin(phi)
        n3 = torch.cos(theta)
        return torch.stack([n1, n2, n3, dist], dim=1)


def local_planar_guidance(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """[B, 4, h, w] planes (n1, n2, n3, n4) -> depth [B, h r, w r]: each
    plane repeated over its r x r patch, the depth n4 / (n1 u + n2 v + n3)
    at the patch's offsets u (along W) and v (along H), (i - (r - 1) / 2) / r."""
    r = upratio
    pe = torch.repeat_interleave(torch.repeat_interleave(plane_eq, r, dim=2), r, dim=3)
    h, w = plane_eq.shape[2], plane_eq.shape[3]
    offs = (torch.arange(r, dtype=pe.dtype, device=pe.device) - (r - 1) * 0.5) / r
    u = offs.repeat(w)
    v = offs.repeat(h)
    return pe[:, 3] / (pe[:, 0] * u[None, None, :] + pe[:, 1] * v[None, :, None] + pe[:, 2])


def plane_depth(pe: torch.Tensor, upratio: int, max_depth: float) -> torch.Tensor:
    """A `Reduction1x1` plane [B, 4, h, w] with its normal made unit (the
    norm clamped at 1e-12) through the local planar guidance at `upratio`,
    over max_depth: [B, 1, h r, w r]."""
    normal = pe[:, :3]
    normal = normal / torch.clamp_min(torch.linalg.vector_norm(normal, dim=1, keepdim=True), 1e-12)
    depth = local_planar_guidance(torch.cat([normal, pe[:, 3:]], dim=1), upratio)
    return depth[:, None] / max_depth


class BTSDecoder(nn.Module):
    conv_init = "xavier_uniform"

    def __init__(self, option, feat_channels, num_features: int = 512):
        super().__init__()
        opt = option.model
        self.min_depth, self.max_depth = float(opt.min_depth), float(opt.max_depth)
        nf = num_features
        _, c0, c1, c2, c3, c4 = feat_channels

        self.upconv5 = Upconv(c4, nf)
        self.bn5 = bts_bn(nf)
        self.conv5 = conv3x3(nf + c3, nf)
        self.upconv4 = Upconv(nf, nf // 2)
        self.bn4 = bts_bn(nf // 2)
        self.conv4 = conv3x3(nf // 2 + c2, nf // 2)
        self.bn4_2 = bts_bn(nf // 2)
        width = nf // 2 + c2  # concat4
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False)
        width += nf // 4
        for d in (6, 12, 18, 24):
            setattr(self, f"daspp_{d}", AtrousConv(width, nf // 4, d))
            width += nf // 4
        self.daspp_conv = conv3x3(nf // 2 + 5 * (nf // 4), nf // 4)
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, self.max_depth)

        self.upconv3 = Upconv(nf // 4, nf // 4)
        self.bn3 = bts_bn(nf // 4)
        self.conv3 = conv3x3(nf // 4 + c1 + 1, nf // 4)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, self.max_depth)

        self.upconv2 = Upconv(nf // 4, nf // 8)
        self.bn2 = bts_bn(nf // 8)
        self.conv2 = conv3x3(nf // 8 + c0 + 1, nf // 8)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, self.max_depth)

        self.upconv1 = Upconv(nf // 8, nf // 16)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, self.max_depth, is_final=True)
        self.conv1 = conv3x3(nf // 16 + self.reduc1x1.out_channels + 3, nf // 16)
        self.get_depth = conv3x3(nf // 16, 1)

    def forward(self, features):
        skip0, skip1, skip2, skip3 = features[1:5]
        dense = torch.relu(features[5])

        up5 = self.bn5(self.upconv5(dense))  # 1/16
        iconv5 = F.elu(self.conv5(torch.cat([up5, skip3], 1)))

        up4 = self.bn4(self.upconv4(iconv5))  # 1/8
        concat4 = torch.cat([up4, skip2], 1)
        iconv4 = self.bn4_2(F.elu(self.conv4(concat4)))

        d3 = self.daspp_3(iconv4)
        chain, dense_aspp = torch.cat([concat4, d3], 1), [iconv4, d3]
        for d in (6, 12, 18, 24):
            out = getattr(self, f"daspp_{d}")(chain)
            dense_aspp.append(out)
            if d < 24:
                chain = torch.cat([chain, out], 1)
        daspp_feat = F.elu(self.daspp_conv(torch.cat(dense_aspp, 1)))

        depth_8x8 = plane_depth(self.reduc8x8(daspp_feat), 8, self.max_depth)
        depth_8x8_ds = downsample2d_nearest(depth_8x8, 4, CF)

        up3 = self.bn3(self.upconv3(daspp_feat))  # 1/4
        iconv3 = F.elu(self.conv3(torch.cat([up3, skip1, depth_8x8_ds], 1)))
        depth_4x4 = plane_depth(self.reduc4x4(iconv3), 4, self.max_depth)
        depth_4x4_ds = downsample2d_nearest(depth_4x4, 2, CF)

        up2 = self.bn2(self.upconv2(iconv3))  # 1/2
        iconv2 = F.elu(self.conv2(torch.cat([up2, skip0, depth_4x4_ds], 1)))
        depth_2x2 = plane_depth(self.reduc2x2(iconv2), 2, self.max_depth)

        up1 = self.upconv1(iconv2)  # 1
        reduc1x1 = self.reduc1x1(up1)
        iconv1 = F.elu(self.conv1(torch.cat([up1, reduc1x1, depth_2x2, depth_4x4, depth_8x8], 1)))
        final = torch.sigmoid(self.get_depth(iconv1))
        return torch.clamp_min(self.max_depth * final, self.min_depth)[:, 0]


@register_model("bts")
class BTS(nn.Module):
    def __init__(self, option):
        super().__init__()
        opt = option.model
        self.encoder = make_encoder(opt.encoder, int(opt.get("input_channel", 3)))
        self.decoder = BTSDecoder(option, self.encoder.channels, int(opt.bts_size))

    def forward(self, batch: dict) -> dict:
        skips = self.encoder(torch.movedim(batch["center"], -1, 1))
        depth = self.decoder(skips)
        return {"pred_depth": depth[:, None], "ref_feature": torch.amax(skips[1], dim=1)}
