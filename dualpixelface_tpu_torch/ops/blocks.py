"""Shared building blocks (counterpart of `dualpixelface_tpu/ops/blocks.py`).

Only the plain math is ported. The JAX package's `_DPack*`, `_PackedTConv3D`,
`S2D*` and `_DSliceConv3D` are exact relayouts of these same convolutions for
the TPU's matrix unit; here every convolution is the plain channels-first
cuDNN one. Module and attribute names follow the reference torch
`state_dict` (`convbn` = Sequential(conv, bn), ...), so checkpoints exported
by the JAX package load strictly.
"""
from __future__ import annotations

import torch
from torch import nn


def torch_pad(kernel_size: int, dilation: int = 1) -> int:
    """The reference's dilation-aware padding: dilation*(k-1)//2."""
    return dilation * (kernel_size - 1) // 2


class ConvBN(nn.Sequential):
    """2-D conv + BatchNorm, no activation. [B, C, H, W]."""

    def __init__(self, in_ch, features, kernel_size=3, strides=1, pad=None,
                 dilation=1, use_bias=False):
        p = pad if pad is not None else torch_pad(kernel_size, dilation)
        super().__init__(
            nn.Conv2d(in_ch, features, kernel_size, strides, p, dilation, bias=use_bias),
            nn.BatchNorm2d(features, eps=1e-5, momentum=0.1),
        )


class ConvBN3D(nn.Sequential):
    """3-D conv + BatchNorm, no activation. [B, C, D, H, W]. The 3x3x3 pad-1
    convs are the dense conv the JAX package computes as `_DSliceConv3D`."""

    def __init__(self, in_ch, features, kernel_size=3, strides=1, pad=None):
        p = pad if pad is not None else (kernel_size - 1) // 2
        super().__init__(
            nn.Conv3d(in_ch, features, kernel_size, strides, p, bias=False),
            nn.BatchNorm3d(features, eps=1e-5, momentum=0.1),
        )


class TConvBN3D(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1) + BatchNorm: output
    spatial size exactly 2x the input."""

    def __init__(self, in_ch, features):
        super().__init__(
            nn.ConvTranspose3d(in_ch, features, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm3d(features, eps=1e-5, momentum=0.1),
        )


def PReLU(init: float = 0.05) -> nn.PReLU:
    """Single-parameter PReLU (torch PReLU(init=w)); x >= 0 passes through."""
    return nn.PReLU(num_parameters=1, init=init)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise kxk + pointwise 1x1 + BN + PReLU."""

    def __init__(self, in_ch, features, kernel_size=3, padding=1, reluw=0.05):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel_size, 1, padding, groups=in_ch, bias=False)
        self.pointwise = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.prelu = PReLU(reluw)

    def forward(self, x):
        return self.prelu(self.bn(self.pointwise(self.depthwise(x))))


class InstanceNorm(nn.Module):
    """Per-sample, per-channel norm over all spatial dims with affine params
    (torch InstanceNorm(affine=True)), channel dim 1. Statistics are taken
    in f32 as E[x^2] - E[x]^2; the affine is applied in the input dtype.
    `stats=(mean, var)` supplies statistics computed elsewhere (the
    fast-attention path pools them over several tensors)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, stats=None):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if stats is None:
            xf = x.float()
            red = tuple(range(2, x.ndim))
            mean = xf.mean(dim=red, keepdim=True)
            var = xf.square().mean(dim=red, keepdim=True) - mean.square()
        else:
            mean, var = stats
        inv = torch.rsqrt(var + self.eps)
        w = self.weight.float().reshape(shape)
        a = (inv * w).to(x.dtype)
        b = (self.bias.float().reshape(shape) - mean * inv * w).to(x.dtype)
        return x * a + b
