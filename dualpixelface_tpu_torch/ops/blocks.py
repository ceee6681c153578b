"""Shared building blocks (counterpart of `dualpixelface_tpu/ops/blocks.py`).

Only the plain math is ported. The JAX package's `_DPack*`, `_PackedTConv3D`,
`S2D*` and `_DSliceConv3D` are exact relayouts of these same convolutions for
the TPU's matrix unit; here every convolution is the plain channels-first
cuDNN one. Module and attribute names follow the reference torch
`state_dict` (`convbn` = Sequential(conv, bn), ...), so checkpoints exported
by the JAX package load strictly. Every BatchNorm is `BatchNorm2d` or
`BatchNorm3d` below, which train with Flax's semantics.
"""
from __future__ import annotations

import torch
from torch import nn

from dualpixelface_tpu_torch import parallel


class _FlaxTrainBatchNorm:
    """Train mode as Flax's `nn.BatchNorm`: statistics in f32 (f64 for an
    f64 input) over every axis but the channels, the variance biased and
    taken as E[x^2] - E[x]^2 clamped at 0; y = (x - mean) * (rsqrt(var +
    eps) * w) + b in that type, returned in x's dtype; running mean and
    variance updated in their own type with the BIASED variance at the
    module's momentum (0.1 unless given: Flax's 0.9 decay; BTS's decoder
    0.01 with eps 1.1e-5). Each call updates them, so a module called
    twice in one forward (the ASM mask head) updates twice, as the Flax
    module does. torch's own BatchNorm updates with the unbiased variance.
    Eval mode is torch's (running statistics), unchanged. State-dict names
    are torch's.

    With a process group of several ranks (`parallel`), the statistics are
    the global batch's, as JAX's one program over the mesh takes them:
    sum(x), sum(x^2) and the count, in f32, summed over the ranks by the
    autograd all-reduce (so the gradient through the global mean and
    variance reaches every rank's input), then the mean and the biased
    variance. Every rank then updates its running statistics alike. One
    process keeps its own means, so its numbers stay as they were."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        red = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if parallel.world().size > 1:
            c = x.shape[1]
            count = xf.new_full((1,), xf.numel() // c)
            moments = parallel.all_reduce_sum(torch.cat([xf.sum(dim=red), xf.square().sum(dim=red), count]))
            mean, meansq = moments[:c] / moments[-1], moments[c:2 * c] / moments[-1]
        else:
            mean, meansq = xf.mean(dim=red), xf.square().mean(dim=red)
        var = torch.clamp_min(meansq - mean.square(), 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.to(xf.dtype).reshape(shape)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxTrainBatchNorm, nn.BatchNorm2d):
    """`momentum` is torch's (the running statistics' weight of the new
    batch): Flax's `momentum=m` is torch's 1 - m."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(features, eps=eps, momentum=momentum)


class BatchNorm3d(_FlaxTrainBatchNorm, nn.BatchNorm3d):
    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)


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
            BatchNorm2d(features),
        )


class ConvBN3D(nn.Sequential):
    """3-D conv + BatchNorm, no activation. [B, C, D, H, W]. The 3x3x3 pad-1
    convs are the dense conv the JAX package computes as `_DSliceConv3D`.
    `kernel_size`, `strides` and `pad` take an int or a (D, H, W) triple;
    the default pad is (k - 1) // 2 per axis."""

    def __init__(self, in_ch, features, kernel_size=3, strides=1, pad=None):
        ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
        p = pad if pad is not None else tuple((k - 1) // 2 for k in ks)
        super().__init__(
            nn.Conv3d(in_ch, features, kernel_size, strides, p, bias=False),
            BatchNorm3d(features),
        )


class TConvBN3D(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1) + BatchNorm: output
    spatial size exactly 2x the input."""

    def __init__(self, in_ch, features):
        super().__init__(
            nn.ConvTranspose3d(in_ch, features, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            BatchNorm3d(features),
        )


class PReLU(nn.Module):
    """Single-parameter PReLU, `where(x >= 0, x, a * x)` as the JAX package
    computes it: at x = 0 exactly the input's gradient is 1, where torch's
    `nn.PReLU` gives a. Exact zeros are common (a conv without bias over a
    ReLU-zeroed patch). The parameter is `weight` of shape [1], as torch's."""

    def __init__(self, init: float = 0.05):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class LeakyReLU(nn.Module):
    """`where(x >= 0, x, slope * x)`, Flax's `nn.leaky_relu`: gradient 1 at
    x = 0 exactly, where torch's `nn.LeakyReLU` gives the slope."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.slope)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise kxk + pointwise 1x1 + BN + PReLU."""

    def __init__(self, in_ch, features, kernel_size=3, padding=1, reluw=0.05):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel_size, 1, padding, groups=in_ch, bias=False)
        self.pointwise = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn = BatchNorm2d(features)
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
