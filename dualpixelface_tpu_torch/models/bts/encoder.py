"""BTS's backbones: ResNet-50/101, ResNeXt-50/101 and DenseNet-121/161
(counterpart of `dualpixelface_tpu/models/bts/encoder.py`).

Parameters carry torchvision's names (`conv1`, `bn1`,
`layer1.0.downsample.0`, `features.denseblock1.denselayer1.norm1`, ...), so
a torchvision state_dict (without DenseNet's `classifier`) loads into an
encoder with strict=True, and the one the JAX package's
`tools/convert_bts_encoder.py` reads is this encoder's own. Each encoder
returns six skips, [x, relu, layer1, layer2, layer3, layer4] or DenseNet's
[x, relu0, pool0, transition1, transition2, norm5], at 1, 1/2, 1/4, 1/8,
1/16 and 1/32 of the input; `channels` lists their widths. Every BatchNorm
is `ops.blocks.BatchNorm2d` at Flax's momentum 0.9, eps 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d

RESNET_SPECS = {
    "resnet50_bts": dict(blocks=(3, 4, 6, 3), groups=1, width_per_group=64),
    "resnet101_bts": dict(blocks=(3, 4, 23, 3), groups=1, width_per_group=64),
    "resnext50_bts": dict(blocks=(3, 4, 6, 3), groups=32, width_per_group=4),
    "resnext101_bts": dict(blocks=(3, 4, 23, 3), groups=32, width_per_group=8),
}

DENSENET_SPECS = {
    # (growth rate, layers a block, initial features) as torchvision's
    "densenet121_bts": dict(growth=32, blocks=(6, 12, 24, 16), init=64),
    "densenet161_bts": dict(growth=48, blocks=(6, 12, 36, 24), init=96),
}


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (the stride on the grouped 3x3)."""

    def __init__(self, in_ch, planes, stride=1, downsample=False, groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
                                        BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(y + x)


class ResNetEncoder(nn.Module):
    def __init__(self, encoder: str = "resnet50_bts", in_ch: int = 3):
        super().__init__()
        spec = RESNET_SPECS[encoder]
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        width, planes = 64, 64
        for li, nblocks in enumerate(spec["blocks"]):
            stride = 1 if li == 0 else 2
            blocks = [Bottleneck(width, planes, stride, True, spec["groups"], spec["width_per_group"])]
            blocks += [Bottleneck(planes * 4, planes, 1, False, spec["groups"], spec["width_per_group"])
                       for _ in range(1, nblocks)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            width, planes = planes * 4, planes * 2
        self.channels = [in_ch, 64, 256, 512, 1024, 2048]

    def forward(self, x):
        skips = [x]
        y = torch.relu(self.bn1(self.conv1(x)))
        skips.append(y)  # relu, 1/2
        y = F.max_pool2d(y, 3, 2, 1)
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
            skips.append(y)  # layer1 .. layer4, 1/4 .. 1/32
        return skips


class DenseLayer(nn.Module):
    """torchvision's _DenseLayer (bn_size 4): its input and its growth."""

    def __init__(self, in_ch, growth):
        super().__init__()
        self.norm1 = BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.norm2 = BatchNorm2d(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch, features):
        super().__init__()
        self.norm = BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNetEncoder(nn.Module):
    def __init__(self, encoder: str = "densenet121_bts", in_ch: int = 3):
        super().__init__()
        spec = DENSENET_SPECS[encoder]
        growth, init = spec["growth"], spec["init"]
        self.features = feats = nn.Module()
        feats.conv0 = nn.Conv2d(in_ch, init, 7, 2, 3, bias=False)
        feats.norm0 = BatchNorm2d(init)
        width = init
        self.channels = [in_ch, init, init]
        for bi, nlayers in enumerate(spec["blocks"]):
            block = nn.Module()
            for li in range(nlayers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(width + li * growth, growth))
            feats.add_module(f"denseblock{bi + 1}", block)
            width += nlayers * growth
            if bi < len(spec["blocks"]) - 1:
                feats.add_module(f"transition{bi + 1}", Transition(width, width // 2))
                width //= 2
                if bi < 2:
                    self.channels.append(width)
        feats.norm5 = BatchNorm2d(width)
        self.channels.append(width)
        self.nblocks = len(spec["blocks"])

    def forward(self, x):
        f = self.features
        skips = [x]
        y = torch.relu(f.norm0(f.conv0(x)))
        skips.append(y)  # relu0, 1/2
        y = F.max_pool2d(y, 3, 2, 1)
        skips.append(y)  # pool0, 1/4
        for bi in range(1, self.nblocks + 1):
            for layer in getattr(f, f"denseblock{bi}").children():
                y = layer(y)
            if bi < self.nblocks:
                y = getattr(f, f"transition{bi}")(y)
                if bi <= 2:
                    skips.append(y)  # transition1, transition2: 1/8, 1/16
        skips.append(f.norm5(y))  # norm5, 1/32
        return skips


def make_encoder(encoder: str, in_ch: int = 3) -> nn.Module:
    """The encoder named by BTS's `encoder` key."""
    if encoder in DENSENET_SPECS:
        return DenseNetEncoder(encoder, in_ch)
    if encoder in RESNET_SPECS:
        return ResNetEncoder(encoder, in_ch)
    raise NotImplementedError(f"BTS encoder {encoder!r}; have {sorted(RESNET_SPECS) + sorted(DENSENET_SPECS)}")
