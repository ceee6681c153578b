"""3-D deformable convolution (counterpart of
`dualpixelface_tpu/ops/deform_conv3d.py`; the reference's "D3D" module).

The op itself is `ops/kernels/deform_fused.deform_conv3d_fused`,
channels-last, for the 3x3x3 / stride 1 / pad 1 geometry the ANM uses:
trilinear sampling at base + offset, zero outside, then a contraction with
the weight, plus bias. With `aperture` the H/W positions are clamped to the
+-AP window (the JAX package's `deform_impl='pallas'` semantics); without,
sampling is unbounded (the reference's, `packed8`). It runs through kernel
K1 on the card and its plain version on the CPU.

`DeformConvPack3D` predicts its own offsets with a zero-initialised 3x3x3
conv (kernel K5, `ops/kernels/conv3d_dslice.py`) and returns
(output, offset).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice
from dualpixelface_tpu_torch.ops.kernels.deform_fused import AP, EPS, KTAPS, deform_conv3d_fused


def clamp_offsets_to_window(offset: torch.Tensor) -> torch.Tensor:
    """Clamp predicted offsets so every H/W sampling position lies inside
    the +-AP window: per tap, dH in [-AP - (kh-1), AP + 1 - EPS - (kh-1)],
    likewise dW with kw; dD unbounded. The forward value is
    offset + (clipped - offset) and the gradient is straight-through (the
    identity), as in the JAX package: a clipped offset keeps receiving the
    window-interior signal."""
    if offset.shape[-1] != 3 * KTAPS:
        raise ValueError(f"offset channels {offset.shape[-1]} != {3 * KTAPS}")
    lo, hi = _window_bounds(offset.device, offset.dtype)
    clipped = torch.minimum(torch.maximum(offset, lo), hi)
    return offset + (clipped - offset).detach()


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _window_bounds(device, dtype):
    """Per-channel (lo, hi) offset bounds of `clamp_offsets_to_window`, on
    the device once (a per-call host copy would drain the stream). Callers
    only read them."""
    kz, ky, kx = np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij")
    base_h = ky.reshape(-1) - 1
    base_w = kx.reshape(-1) - 1
    big = np.float32(1e9)
    lo = np.stack([-big * np.ones(KTAPS), -AP - base_h, -AP - base_w], -1).reshape(3 * KTAPS)
    hi = np.stack([big * np.ones(KTAPS), AP + 1 - EPS - base_h, AP + 1 - EPS - base_w], -1).reshape(3 * KTAPS)
    return tuple(torch.as_tensor(a, device=device).to(dtype) for a in (lo, hi))


class DeformConvPack3D(nn.Module):
    """Self-offset-predicting deformable 3x3x3 conv, stride 1, pad 1
    (reference DeformConvPack_dv2, dimension 'THW'). Input and output are
    channels-last [B, D, H, W, C].

    impl='pallas' selects the windowed semantics when D <= 4 (the JAX
    package's rule: its TPU kernel held at most 4 planes), and the unbounded
    semantics otherwise; impl='packed8' is always unbounded. Both run through
    the same kernel. `offset_clamp` clamps the predicted offsets to the
    window first (`clamp_offsets_to_window`)."""

    def __init__(self, in_ch: int, features: int, impl: str = "pallas", offset_clamp: bool = False):
        super().__init__()
        if impl not in ("pallas", "packed8"):
            raise ValueError(f"deform impl {impl!r} not in ('pallas', 'packed8')")
        self.impl = impl
        self.offset_clamp = offset_clamp
        self.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(features))
        self.conv_offset = nn.Conv3d(in_ch, 3 * KTAPS, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor):
        dt = x.dtype
        w_off = self.conv_offset.weight.permute(2, 3, 4, 1, 0).contiguous().to(dt)
        offset = conv3d_dslice(x, w_off, self.conv_offset.bias.to(dt))
        if self.offset_clamp:
            offset = clamp_offsets_to_window(offset)
        aperture = self.impl == "pallas" and x.shape[1] <= 4
        weight = self.weight.permute(2, 3, 4, 1, 0).contiguous().to(dt)
        out = deform_conv3d_fused(x, offset, weight, self.bias.to(dt), aperture=aperture)
        return out, offset
