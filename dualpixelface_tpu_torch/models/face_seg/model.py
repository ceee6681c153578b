"""BiSeNet face parser, the demo-mask tool's network (counterpart of
`dualpixelface_tpu/models/face_seg/model.py`).

A ResNet18 backbone with attention refinement at 1/16 and 1/32 (the
context path), the backbone's 1/8 feature in place of the spatial path, a
feature fusion module, and three heads upsampled to the input size
(align-corners bilinear). Channels-first [B, 3, H, W] in, three [B,
n_classes, H, W] logit maps out.

Modules carry the reference's state_dict names (`cp.resnet.*`, `cp.arm16.*`,
`cp.conv_avg.*`, `ffm.*`, `conv_out{,16,32}.*`), so the reference's
`79999_iter.pth` loads with strict=True. Every BatchNorm is
`ops.blocks.BatchNorm2d` (Flax's momentum 0.9, eps 1e-5); every conv is
bias-free. Not a registered model: it has no run config, as in JAX.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d
from dualpixelface_tpu_torch.ops.resize import resize_linear, resize_nearest


def _conv(in_ch: int, out_ch: int, ks: int = 1, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, ks, stride, padding, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = _conv(in_ch, out_ch, ks, stride, padding)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3, stride, 1)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3, 1, 1)
        self.bn2 = BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(_conv(in_ch, out_ch, 1, stride), BatchNorm2d(out_ch))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class Resnet18(nn.Module):
    """(feat8 [128 ch], feat16 [256], feat32 [512]): layer2-4's outputs."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        y = self.layer1(self.maxpool(torch.relu(self.bn1(self.conv1(x)))))
        feat8 = self.layer2(y)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, out_ch)
        self.conv_atten = _conv(out_ch, out_ch)
        self.bn_atten = BatchNorm2d(out_ch)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    """(feat8, f16_up, f32_up): the backbone's 1/8 feature and the refined
    1/16 and 1/32 features, each nearest-upsampled one scale and passed
    through its head."""

    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(resize_nearest(f32, feat16.shape[2:], (2, 3)))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(resize_nearest(f16, feat8.shape[2:], (2, 3)))
        return feat8, f16_up, f32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, out_ch, 1, 1, 0)
        self.conv1 = _conv(out_ch, out_ch // 4)
        self.conv2 = _conv(out_ch // 4, out_ch)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        atten = torch.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        atten = torch.sigmoid(self.conv2(atten))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_ch: int, mid: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid)
        self.conv_out = _conv(mid, n_classes)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        """x [B, 3, H, W] -> (out, out16, out32), each [B, n_classes, H, W]."""
        size = x.shape[2:]
        feat8, f16_up, f32_up = self.cp(x)
        fuse = self.ffm(feat8, f16_up)
        heads = (self.conv_out(fuse), self.conv_out16(f16_up), self.conv_out32(f32_up))
        return tuple(resize_linear(o, size, (2, 3), align_corners=True) for o in heads)


@torch.no_grad()
def init_bisenet(model: BiSeNet, seed: int = 0) -> BiSeNet:
    """The JAX model's init from `seed`: each conv He-normal over its fan
    in (Flax's `kaiming_normal`), BatchNorms at identity with running
    statistics (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * math.sqrt(2.0 / mod.weight[0].numel()))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model
