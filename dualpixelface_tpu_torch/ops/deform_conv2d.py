"""2-D deformable and modulated deformable convolution, DCNv1/v2
(counterpart of `dualpixelface_tpu/ops/deform_conv2d.py`, which stands for
the reference's `dcn` CUDA extension; no path of the system calls it).

A plain torch gather of the bilinear samples (im2col at the offset
positions) and one `torch.matmul`, as the JAX version is a gather and one
`dot_general`; the JAX package runs it outside any Pallas kernel, so it has
no kernel here either. Offsets per tap k (row-major over the window):
channels (2k, 2k+1) = (dy, dx); the modulated variant multiplies each
sample by a per-tap mask (DCNv2).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    stride: int | Sequence[int] = 1,
    padding: int | Sequence[int] = 1,
    dilation: int | Sequence[int] = 1,
) -> torch.Tensor:
    """x [B, H, W, Cin]; offset [B, Ho, Wo, 2K] (dy, dx per tap); weight
    [KH, KW, Cin, Cout]; mask [B, Ho, Wo, K] or None. Returns [B, Ho, Wo,
    Cout]: bilinear samples, zero outside the image, contracted with the
    weight in f32, plus bias."""
    st, pad, dil = _pair(stride), _pair(padding), _pair(dilation)
    b, h, w, cin = x.shape
    kh, kw, cin_w, cout = weight.shape
    if cin_w != cin:
        raise ValueError(f"weight takes {cin_w} input channels, x has {cin}")
    k = kh * kw
    _, ho, wo, off_c = offset.shape
    if off_c != 2 * k:
        raise ValueError(f"offset channels {off_c} != 2 x {k} taps")
    n = ho * wo

    f32, dev = torch.float32, x.device
    yy, xx = torch.meshgrid(torch.arange(ho, device=dev), torch.arange(wo, device=dev), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev), torch.arange(kw, device=dev), indexing="ij")
    base_h = (yy.reshape(-1, 1) * st[0] - pad[0] + ky.reshape(1, -1) * dil[0]).to(f32)
    base_w = (xx.reshape(-1, 1) * st[1] - pad[1] + kx.reshape(1, -1) * dil[1]).to(f32)

    off = offset.reshape(b, n, k, 2).to(f32)
    pos_h = base_h[None] + off[..., 0]
    pos_w = base_w[None] + off[..., 1]
    h0, w0 = torch.floor(pos_h), torch.floor(pos_w)
    fh, fw = pos_h - h0, pos_w - w0

    x_flat = x.reshape(b, h * w, cin)
    cols = None
    for cy in (0, 1):
        yi = h0 + cy
        wy = 1.0 - fh if cy == 0 else fh
        y_ok = (yi >= 0) & (yi <= h - 1)
        for cx in (0, 1):
            xi = w0 + cx
            wx = 1.0 - fw if cx == 0 else fw
            x_ok = (xi >= 0) & (xi <= w - 1)
            wgt = (wy * wx) * (y_ok & x_ok).to(f32)
            lin = torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long()
            gathered = torch.gather(x_flat, 1, lin.reshape(b, n * k, 1).expand(-1, -1, cin)).reshape(b, n, k, cin)
            term = gathered * wgt[..., None].to(x.dtype)
            cols = term if cols is None else cols + term

    if mask is not None:
        cols = cols * mask.reshape(b, n, k, 1).to(cols.dtype)

    out = torch.matmul(cols.reshape(b, n, k * cin).to(f32), weight.reshape(k * cin, cout).to(f32)).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(b, ho, wo, cout)


class DeformConvPack2D(nn.Module):
    """Self-offset 2-D deformable conv (the reference dcn's DeformConvPack);
    `modulated` adds the DCNv2 sigmoid mask head (ModulatedDeformConvPack).
    Input and output are channels-last [B, H, W, C]; `forward` returns
    (out, offset). Parameters as torch names them: `weight` [Cout, Cin, KH,
    KW], `bias` [Cout], `conv_offset` (a Conv2d of 2K, or 3K with the mask,
    channels, zero at init). The weight and bias start U(+-1/sqrt(fan in)),
    from `generator` where given."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 modulated: bool = False, use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size, self.stride, self.padding, self.modulated = kernel_size, stride, padding, modulated
        k = kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.conv_offset = nn.Conv2d(in_ch, (3 if modulated else 2) * k, kernel_size, stride, padding, bias=True)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_((torch.rand(self.weight.shape, generator=generator) * 2 - 1) * bound)
        if self.bias is not None:
            self.bias.copy_((torch.rand(self.bias.shape, generator=generator) * 2 - 1) * bound)
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

    def forward(self, x: torch.Tensor):
        k = self.kernel_size * self.kernel_size
        head = self.conv_offset(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.modulated:
            offset, mask = head[..., : 2 * k], torch.sigmoid(head[..., 2 * k:])
        else:
            offset, mask = head, None
        out = deform_conv2d(x, offset, self.weight.permute(2, 3, 1, 0), self.bias, mask,
                            stride=self.stride, padding=self.padding)
        return out, offset
