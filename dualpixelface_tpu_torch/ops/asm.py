"""Adaptive Sampling Module: sub-pixel shifts and masking attention
(counterpart of `dualpixelface_tpu/ops/asm.py`).

The dual-pixel disparity axis is the image H axis; `forward` shifts by
+disp, `backward` by -disp. All D planes are produced at once: the nearest
and bilinear shifts are static slice-and-pad copies, and the Fourier shift
is one real [D, H, H] operator (`phase_shift_matrix`) applied as a matmul.
Every function takes the axis that holds H, and inserts the plane axis D
just before it (`axis=1` is the JAX layout [B, H, W, C]; the port's modules
call with `axis=2` on [B, C, H, W]).

`MaskingAttention` computes both of the JAX package's formulations: the
exact one (the mask head on every shifted plane and mode) and the
`fast_attention` one (the head hoisted before the shifts). The JAX package's
stacked, flat and mode-packed (`mpack`) exact layouts and its `asm_head_s2d`
head are relayouts of the same exact math (`tests/test_asm.py` pins them
equal); here it is one plain formulation.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d, InstanceNorm, PReLU
from dualpixelface_tpu_torch.utils.profiling import span, to_device


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


def _compat_nearest_index(n: int, delta: float) -> tuple[np.ndarray, np.ndarray]:
    """The reference's nearest sampling index along one axis: an
    align-corners grid (v / (n - 1) * 2 - 1) read by grid_sample with
    align_corners=False, so the source position is
    (i + delta) * n / (n - 1) - 0.5, a stretch rather than a shift (for even
    n it even zeroes the last row). np.round is half to even, as
    grid_sample's nearbyint. Returns (clipped index, in-range mask)."""
    pos = (np.arange(n) + delta) * n / (n - 1) - 0.5
    idx = np.round(pos).astype(np.int64)
    valid = (idx >= 0) & (idx <= n - 1)
    return np.clip(idx, 0, n - 1), valid


def shift_h_nearest_compat(x: torch.Tensor, delta: float, axis: int = 1) -> torch.Tensor:
    """The reference's nearest branch bit for bit (`compat_nearest`): the H
    axis (`axis`) takes the stretched +delta map and the W axis (axis + 1)
    the delta = 0 map, both remapped, as grid_sample sees the 2-D grid."""
    h, w = x.shape[axis], x.shape[axis + 1]
    idx_h, ok_h = _compat_nearest_index(h, delta)
    idx_w, ok_w = _compat_nearest_index(w, 0.0)
    out = torch.index_select(x, axis, to_device(idx_h, x.device))
    out = torch.index_select(out, axis + 1, to_device(idx_w, x.device))
    shape_h = [1] * x.ndim
    shape_h[axis] = h
    shape_w = [1] * x.ndim
    shape_w[axis + 1] = w
    mask = (to_device(ok_h, x.device, x.dtype).reshape(shape_h)
            * to_device(ok_w, x.device, x.dtype).reshape(shape_w))
    return out * mask


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
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _phase_operator(h: int, deltas: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The operator on the device, built once per shape: the JAX package
    folds it at trace time; rebuilt per call it cost the host ~0.25 s at
    H = 192 (profile_serving.py). Callers only read it."""
    return to_device(phase_shift_matrix(h, deltas), device).to(dtype)


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
    plane axis D inserted before `axis` (the JAX `layout='list'`).
    `compat_nearest` takes the reference's stretched nearest grid
    (`shift_h_nearest_compat`)."""
    sign = 1.0 if direction == "forward" else -1.0
    shift_nearest = shift_h_nearest_compat if compat_nearest else shift_h_nearest
    modes = []
    if nearest:
        modes.append(torch.stack([shift_nearest(feat, sign * d, axis) for d in disps], dim=axis))
    if bilinear:
        modes.append(torch.stack([shift_h_bilinear(feat, sign * d, axis) for d in disps], dim=axis))
    if phase:
        modes.append(phase_shift_multi(feat, [sign * d for d in disps], axis))
    return modes


class MaskingAttention(nn.Module):
    """Shift-mode gating attention. A mask head (conv 3x3 -> BN -> relu ->
    conv 1x1) scores each shift mode; the InstanceNorm statistics are pooled
    over (mode, h, w) per (sample, plane, channel); the activation (sigmoid,
    or a PReLU for `act="relu"`) and a softmax over the modes gate the
    shifted features, then their mean (or variance, `feature_fetch`) over
    modes. Input [B, C, H, W] and the shift function, output
    [B, C, D, H, W].

    `forward` is the exact attention: the head runs on every (plane, mode)
    of the shifted volume, the train-mode BatchNorm statistics are taken
    over all of them (the set of the JAX package's batch-folded call:
    samples, planes, modes and pixels of one call), one update per call.
    `forward_fast` is the `fast_attention` deviation: the head runs once on
    the unshifted map and the shifts are applied to its output. Both run
    their parts inside tracer spans (`utils/profiling`): `asm.shift` around
    each `shift_fn` call, `asm.mask_head` around the mask head's convs and
    BatchNorm, `asm.gate` around `_gate`.

    The attribute tree is the reference torch module's: `mask_convs` =
    (conv, bn, relu, (conv, norm)) with `normalize` the same norm module
    registered a second time, as the reference does. The PReLU of
    `act="relu"` has no name in the reference's state_dict as the JAX
    package exports it; the port names it `prelu` (init 0.05)."""

    def __init__(self, features: int, act: str = "sigmoid", feature_fetch: bool = False):
        super().__init__()
        if act not in ("sigmoid", "relu"):
            raise NotImplementedError(f"asm activation {act!r}")
        self.feature_fetch = feature_fetch
        self.normalize = InstanceNorm(features)
        self.mask_convs = nn.Sequential(
            nn.Conv3d(features, features, (1, 3, 3), padding=(0, 1, 1), bias=False),
            BatchNorm2d(features),
            nn.ReLU(),
            nn.Sequential(nn.Conv3d(features, features, 1, bias=False), self.normalize),
        )
        self.prelu = PReLU(0.05) if act == "relu" else None

    def _activate(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(t) if self.prelu is None else self.prelu(t)

    def _gate(self, y_modes, mask_modes) -> torch.Tensor:
        """The InstanceNorm with (mode, h, w) statistics and the activation
        on the M mask volumes, a softmax over the mode list (elementwise
        across its entries), the gated features, then their mean or
        variance over the modes."""
        stats = self._mode_stats(mask_modes)
        mask_modes = [self._activate(self.normalize(t, stats=stats)) for t in mask_modes]
        m = len(y_modes)
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

    @staticmethod
    def _mode_stats(mask_modes):
        """f32 (mean, var) over (mode, h, w) per (sample, plane, channel) of
        the M mask volumes [B, F, D, H, W], as E[x^2] - E[x]^2."""
        h, w = mask_modes[0].shape[-2:]
        npix = float(len(mask_modes) * h * w)
        s1 = sum(t.float().sum(dim=(3, 4), keepdim=True) for t in mask_modes)
        s2 = sum(t.float().square().sum(dim=(3, 4), keepdim=True) for t in mask_modes)
        mean = s1 / npix
        return mean, s2 / npix - mean.square()

    def forward(self, x: torch.Tensor, shift_fn) -> torch.Tensor:
        conv0, bn, _, tail = self.mask_convs
        with span("asm.shift"):
            y_modes = shift_fn(x)  # M x [B, C, D, H, W]
        m = len(y_modes)
        b, c, d, h, w = y_modes[0].shape
        with span("asm.mask_head"):
            folded = torch.cat(y_modes, dim=0)  # [M*B, C, D, H, W]
            mask = F.conv3d(folded, conv0.weight, padding=(0, 1, 1))
            # BatchNorm over every (mode, sample, plane, pixel): D*H folded into
            # one axis of the 4-D layout the module takes
            mask = torch.relu(bn(mask.reshape(m * b, -1, d * h, w))).reshape(m * b, -1, d, h, w)
            mask_modes = list(F.conv3d(mask, tail[0].weight).chunk(m, dim=0))
        with span("asm.gate"):
            return self._gate(y_modes, mask_modes)

    def forward_fast(self, x: torch.Tensor, shift_fn) -> torch.Tensor:
        conv0, bn, _, tail = self.mask_convs
        with span("asm.mask_head"):
            mask = F.conv2d(x, conv0.weight[:, :, 0], padding=1)
            mask = F.conv2d(torch.relu(bn(mask)), tail[0].weight[:, :, 0])
        with span("asm.shift"):
            y_modes = shift_fn(x)        # M x [B, C, D, H, W]
        with span("asm.shift"):
            mask_modes = shift_fn(mask)  # M x [B, F, D, H, W]
        with span("asm.gate"):
            return self._gate(y_modes, mask_modes)
