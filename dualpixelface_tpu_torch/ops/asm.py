"""Adaptive Sampling Module: sub-pixel shifts and masking attention
(counterpart of `dualpixelface_tpu/ops/asm.py`).

The dual-pixel disparity axis is the image H axis; `forward` shifts by
+disp, `backward` by -disp. All D planes are produced at once: the nearest
and bilinear shifts are static slice-and-pad copies, and the Fourier shift
is one real [D, H, H] operator (`phase_shift_matrix`) applied as a matmul.
Every function takes the axis that holds H, and inserts the plane axis D
just before it (`axis=1` is the JAX layout [B, H, W, C]; the port's modules
call with `axis=2` on [B, C, H, W]).

Ported: the `fast_attention` (hoisted head) path of `MaskingAttention`.
The exact-attention layouts, `compat_nearest` and `compat_frozen_shift_grid`
raise NotImplementedError in this slice.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.ops.blocks import InstanceNorm


def shift_h_static(x: torch.Tensor, k: int, axis: int = 1) -> torch.Tensor:
    """dst[y] = src[y + k] along `axis`, zero-filled out of bounds."""
    if k == 0:
        return x
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if abs(k) >= n:
        return out
    if k > 0:
        out.narrow(axis, 0, n - k).copy_(x.narrow(axis, k, n - k))
    else:
        out.narrow(axis, -k, n + k).copy_(x.narrow(axis, 0, n + k))
    return out


def shift_h_nearest(x: torch.Tensor, delta: float, axis: int = 1) -> torch.Tensor:
    """Nearest shift: src[round(y + delta)] (round half to even)."""
    return shift_h_static(x, int(np.round(delta)), axis)


def shift_h_bilinear(x: torch.Tensor, delta: float, axis: int = 1) -> torch.Tensor:
    """Bilinear shift with zero padding (grid_sample bilinear,
    align_corners=True, zeros): each integer corner outside contributes 0."""
    lo = int(math.floor(delta))
    w = delta - lo
    out = (1.0 - w) * shift_h_static(x, lo, axis)
    if w != 0.0:
        out = out + w * shift_h_static(x, lo + 1, axis)
    return out


def phase_shift_matrix(h: int, deltas: Sequence[float]) -> np.ndarray:
    """[D, H, H] real operator of the circular Fourier shift by each delta:
    IDFT . diag(exp(2i*pi*delta*k/H)) . DFT."""
    freqs = np.fft.fftfreq(h) * h
    deltas = np.asarray(list(deltas), dtype=np.float64)
    dft = np.fft.fft(np.eye(h))
    idft = np.conj(dft).T / h
    phase = np.exp(2j * np.pi * (deltas[:, None] / h) * freqs[None, :])
    mats = np.einsum("yk,dk,kx->dyx", idft, phase, dft, optimize=True)
    return np.ascontiguousarray(mats.real.astype(np.float32))


@functools.lru_cache(maxsize=16)
def _phase_operator(h: int, deltas: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The operator on the device, built once per shape: the JAX package
    folds it at trace time; rebuilt per call it cost the host ~0.25 s at
    H = 192 (profile_serving.py). Callers only read it."""
    return torch.as_tensor(phase_shift_matrix(h, deltas), device=device).to(dtype)


def phase_shift_multi(x: torch.Tensor, deltas: Sequence[float], axis: int = 1) -> torch.Tensor:
    """Fourier (circular) shift by every delta at once: the plane axis D is
    inserted before `axis`; out[.., i, y, ..] = x[.., y + deltas[i], ..].
    bf16 inputs multiply in bf16 (f32 accumulation), others in f32."""
    cdt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    mats = _phase_operator(x.shape[axis], tuple(float(d) for d in deltas), x.device, cdt)
    xm = torch.movedim(x, axis, -1).to(cdt)  # [..., H]
    y = torch.einsum("dyh,...h->...dy", mats, xm)  # [..., D, H]
    return torch.movedim(y, (-2, -1), (axis, axis + 1)).to(x.dtype)


def subpixel_shift_planes(
    feat: torch.Tensor,
    disps: Sequence[float],
    direction: str,
    nearest: bool = True,
    bilinear: bool = True,
    phase: bool = True,
    compat_nearest: bool = False,
    axis: int = 1,
) -> list[torch.Tensor]:
    """Shift `feat` by every disparity along `axis` in up to three modes.
    Returns the mode list (nearest, bilinear, phase order), each with the
    plane axis D inserted before `axis` (the JAX `layout='list'`)."""
    if compat_nearest:
        raise NotImplementedError(
            "compat_nearest is not ported yet (see ROADMAP.md queue 1)"
        )
    sign = 1.0 if direction == "forward" else -1.0
    modes = []
    if nearest:
        modes.append(torch.stack([shift_h_nearest(feat, sign * d, axis) for d in disps], dim=axis))
    if bilinear:
        modes.append(torch.stack([shift_h_bilinear(feat, sign * d, axis) for d in disps], dim=axis))
    if phase:
        modes.append(phase_shift_multi(feat, [sign * d for d in disps], axis))
    return modes


class MaskingAttention(nn.Module):
    """Shift-mode gating attention, fast (hoisted-head) path.

    The mask head (conv 3x3 -> BN -> relu -> conv 1x1) runs once on the
    unshifted feature map, and the mode shifts are applied to its output.
    The InstanceNorm statistics are pooled over (mode, h, w) per
    (sample, plane, channel); softmax over the modes gates the shifted
    features, then their mean (or variance, `feature_fetch`) over modes.
    Input [B, C, H, W], output [B, C, D, H, W].

    The attribute tree is the reference torch module's: `mask_convs` =
    (conv, bn, relu, (conv, norm)) with `normalize` the same norm module
    registered a second time, as the reference does."""

    def __init__(self, features: int, act: str = "sigmoid", feature_fetch: bool = False):
        super().__init__()
        if act != "sigmoid":
            raise NotImplementedError(f"asm activation {act!r} is not ported yet")
        self.feature_fetch = feature_fetch
        self.normalize = InstanceNorm(features)
        self.mask_convs = nn.Sequential(
            nn.Conv3d(features, features, (1, 3, 3), padding=(0, 1, 1), bias=False),
            nn.BatchNorm2d(features, eps=1e-5, momentum=0.1),
            nn.ReLU(),
            nn.Sequential(nn.Conv3d(features, features, 1, bias=False), self.normalize),
        )

    def forward(self, x: torch.Tensor, shift_fn) -> torch.Tensor:
        conv0, bn, _, tail = self.mask_convs
        mask = F.conv2d(x, conv0.weight[:, :, 0], padding=1)
        mask = F.conv2d(torch.relu(bn(mask)), tail[0].weight[:, :, 0])

        y_modes = shift_fn(x)        # M x [B, C, D, H, W]
        mask_modes = shift_fn(mask)  # M x [B, F, D, H, W]
        m = len(y_modes)
        h, w = mask_modes[0].shape[-2:]
        npix = float(m * h * w)
        s1 = sum(t.float().sum(dim=(3, 4), keepdim=True) for t in mask_modes)
        s2 = sum(t.float().square().sum(dim=(3, 4), keepdim=True) for t in mask_modes)
        mean = s1 / npix
        var = s2 / npix - mean.square()
        mask_modes = [torch.sigmoid(self.normalize(t, stats=(mean, var))) for t in mask_modes]

        mx = mask_modes[0]
        for t in mask_modes[1:]:
            mx = torch.maximum(mx, t)
        exps = [torch.exp(t - mx) for t in mask_modes]
        z = sum(exps)
        gated = [yv * (e / z) for yv, e in zip(y_modes, exps)]
        if self.feature_fetch:
            avg = sum(gated) / m
            return sum(t * t for t in gated) / m - avg * avg
        return sum(gated) / m
