"""DPNet, the encoder-decoder of the dual-pixel pair (counterpart of
`dualpixelface_tpu/models/dpnet/mainmodel.py`).

The reference and target views concatenated along the channels, five
encoder stages of residual `Encoder` blocks (max-pool skips), four
`Decoder` stages (a k4 s2 deconv and three depthwise-separable convs) with
depthwise-separable skips joined through ONE shared PReLU, and five heads
upsampled x16/8/4/2/1 (align-corners bilinear).

The reference's padding algebra is kept as it is: the 1x1 convs have
non-zero padding and the skip max-pools none, which lands all five heads on
the full resolution for crops that are a multiple of 96 (768x576, 288x192,
96x96), and on other sizes elsewhere. Every conv is xavier-uniform without
bias and every PReLU starts at 0.05, as the JAX model's init.

Inputs: batch["left"], batch["right"] [B, H, W, 3]. Outputs, in train and
in eval mode: pred_depth [B, 5, H, W] (the full-resolution head first);
ref_feature [B, H/2, W/2], the channel max of the first stage. Modules are
named after the JAX variable tree (`weights.py` maps Flax's automatic names
in call order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.base import select_ref_target
from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d, DepthwiseSeparableConv, PReLU
from dualpixelface_tpu_torch.ops.resize import resize_linear


class TorchBlock(nn.Module):
    """A conv with explicit torch padding, or a k4 s2 deconv (Flax's VALID
    transposed conv trimmed by `pad` a side, which is torch's
    ConvTranspose2d padding), then optional BatchNorm and PReLU."""

    def __init__(self, in_ch, features, kernel_size=3, stride=1, pad=1, deconv=False, bn=True, relu=True):
        super().__init__()
        make = nn.ConvTranspose2d if deconv else nn.Conv2d
        self.conv = make(in_ch, features, kernel_size, stride, pad, bias=False)
        self.bn = BatchNorm2d(features) if bn else None
        self.prelu = PReLU(0.05) if relu else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return x if self.prelu is None else self.prelu(x)


class Encoder(nn.Module):
    """conv, depthwise-separable conv, 1x1 conv; the skip a padded 1x1 conv
    and a 3x3 max-pool without padding; PReLU of the sum."""

    def __init__(self, in_ch, infilter, outfilter, stride, pad_basic):
        super().__init__()
        self.stride = stride
        self.block = TorchBlock(in_ch, infilter, 3, stride, pad_basic)
        self.dwsep = DepthwiseSeparableConv(infilter, infilter, 3, 1)
        self.out = TorchBlock(infilter, outfilter, 1, 1, 0)
        self.skip = TorchBlock(in_ch, outfilter, 1, 1, pad_basic)
        self.prelu = PReLU(0.05)

    def forward(self, x):
        y = self.out(self.dwsep(self.block(x)))
        skip = F.max_pool2d(self.skip(x), 3, self.stride)
        return self.prelu(y + skip)


class Encoder2(nn.Module):
    """The stem: a k7 s2 conv beside a k7 s2 max-pool of the input,
    concatenated (conv first)."""

    def __init__(self, in_ch, outfilter):
        super().__init__()
        self.block = TorchBlock(in_ch, outfilter, 7, 2, 1)

    def forward(self, x):
        return torch.cat([self.block(x), F.max_pool2d(x, 7, 2, 1)], dim=1)


class Decoder(nn.Module):
    """A k4 s2 deconv and three depthwise-separable convs (3x3, 1x1, 3x3)."""

    def __init__(self, in_ch, infilter, pad_basic, pad_1, pad_2, pad_3):
        super().__init__()
        self.deconv = TorchBlock(in_ch, infilter, 4, 2, pad_basic, deconv=True)
        self.dwsep = nn.ModuleList([DepthwiseSeparableConv(infilter, infilter, k, p)
                                    for k, p in ((3, pad_1), (1, pad_2), (3, pad_3))])

    def forward(self, x):
        x = self.deconv(x)
        for conv in self.dwsep:
            x = conv(x)
        return x


# (name, infilter, outfilter, stride, pad_basic) of the encoder stages after
# the stem
ENCODERS = [("enc_layer1_2", 11, 11, 1, 1),
            ("enc_layer2_1", 16, 32, 2, 0), ("enc_layer2_2", 16, 32, 1, 1), ("enc_layer2_3", 16, 32, 1, 1),
            ("enc_layer3_1", 16, 64, 2, 2), ("enc_layer3_2", 16, 64, 1, 1), ("enc_layer3_3", 16, 64, 1, 1),
            ("enc_layer4_1", 32, 128, 2, 1), ("enc_layer4_2", 32, 128, 1, 1), ("enc_layer4_3", 32, 128, 1, 1),
            ("enc_layer5_1", 32, 128, 2, 1), ("enc_layer5_2", 32, 128, 1, 1), ("enc_layer5_3", 32, 128, 1, 1)]
# (decoder, its args, skip, skip args, 1x1 after, its width) of the four
# skip-joined decoder stages, deepest first
DECODERS = [("dec_layer4", (128, 32, 1, 1, 1, 1), "skip_layer4", (128, 32, 3, 2), "dec_layer4_b", 128),
            ("dec_layer3", (128, 16, 2, 0, 1, 0), "skip_layer3", (64, 16, 3, 3), "dec_layer3_b", 64),
            ("dec_layer2", (64, 16, 4, 0, 0, 0), "skip_layer2", (32, 16, 3, 3), "dec_layer2_b", 32),
            ("dec_layer1", (32, 16, 4, 1, 0, 1), "skip_layer1", (11, 16, 3, 3), "dec_layer1_b", 32)]
# (head, input width, pad, upsampling factor), in the order pred_depth
# stacks them
HEADS = [("conv_last_layer1", 8, 1, 1), ("conv_last_layer2", 32, 1, 2), ("conv_last_layer3", 32, 1, 4),
         ("conv_last_layer4", 64, 0, 8), ("conv_last_layer5", 128, 1, 16)]


@register_model("dpnet")
class DPNET(nn.Module):
    conv_init = "xavier_uniform"

    def __init__(self, option):
        super().__init__()
        self.option = option
        in_ch = 2 * int(option.model.get("input_channel", 3))
        self.enc_layer1_1 = Encoder2(in_ch, 8)
        width = 8 + in_ch  # the stem's conv and its pool of the input
        for name, infilter, outfilter, stride, pad in ENCODERS:
            setattr(self, name, Encoder(width, infilter, outfilter, stride, pad))
            width = outfilter
        self.shared_prelu = PReLU(0.05)  # one parameter for the four skip joins
        for dec, dargs, skip, (sin, sout, k, p), post, width in DECODERS:
            setattr(self, dec, Decoder(*dargs))
            setattr(self, skip, DepthwiseSeparableConv(sin, sout, k, p))
            setattr(self, post, TorchBlock(sout, width, 1, 1, 1, bn=False, relu=False))
        self.last_layer = Decoder(32, 8, 4, 1, 0, 1)
        self.last_layer_b = TorchBlock(8, 8, 1, 1, 1, bn=False, relu=False)
        for name, width, pad, _ in HEADS:
            setattr(self, name, TorchBlock(width, 1, 7, 1, pad))

    def forward(self, batch: dict) -> dict:
        ref_img, tar_img = select_ref_target(batch, self.option)
        x = torch.movedim(torch.cat([ref_img, tar_img], dim=-1), -1, 1)

        x = self.enc_layer1_1(x)
        skips = []
        for name, *_ in ENCODERS:
            if name.endswith("_1"):
                skips.append(x)  # x1 .. x4, the input of each strided stage
            x = getattr(self, name)(x)
        y = x  # x5
        feats = []
        for (dec, _, skip, _, post, _), s in zip(DECODERS, reversed(skips)):
            y = self.shared_prelu(getattr(self, dec)(y) + getattr(self, skip)(s))
            y = getattr(self, post)(y)
            feats.append(y)  # y5, y4, y3, y2
        feats.append(self.last_layer_b(self.last_layer(y)))  # y1

        outs = []
        for (name, _, _, factor), y in zip(HEADS, reversed(feats)):
            o = getattr(self, name)(y)
            if factor > 1:
                o = resize_linear(o, (o.shape[2] * factor, o.shape[3] * factor), (2, 3))
            outs.append(o[:, 0])
        return {"pred_depth": torch.stack(outs, dim=1), "ref_feature": torch.amax(skips[0], dim=1)}
