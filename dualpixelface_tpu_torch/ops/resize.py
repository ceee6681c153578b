"""Align-corners interpolation as small matmuls (counterpart of
`dualpixelface_tpu/ops/resize.py`).

Each 1-D linear operator is a dense [out, in] matrix built on the host in
numpy and contracted along its axis, which reproduces torch
`F.interpolate(..., align_corners=True)` and the JAX package bit for bit in
the operator weights. The public functions keep the JAX layouts
(channels-last); `resize_linear`/`resize_nearest` take explicit axes so the
port's channels-first modules use the same operators.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dualpixelface_tpu_torch.utils.profiling import to_device


@functools.lru_cache(maxsize=128)
def _linear_matrix(out_size: int, in_size: int, align_corners: bool = True) -> np.ndarray:
    """Dense [out, in] linear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if align_corners:
        coords = np.arange(out_size) * (in_size - 1) / max(out_size - 1, 1)
    else:
        coords = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        coords = np.clip(coords, 0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (coords - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1.0 - w
    m[np.arange(out_size), hi] += w
    return m


def _nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """torch 'nearest' source rows: src = floor(dst * in / out)."""
    src = np.floor(np.arange(out_size) * in_size / out_size).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


# The operators are copied to the device once per shape: a copy from
# pageable host memory waits for the stream to drain, and one per call left
# the card idle between kernels (profile_serving.py). Callers only read them.
@functools.lru_cache(maxsize=128)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _device_linear(out_size: int, in_size: int, align_corners: bool, device, dtype) -> torch.Tensor:
    return to_device(_linear_matrix(out_size, in_size, align_corners), device, dtype)


@functools.lru_cache(maxsize=128)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _device_nearest(out_size: int, in_size: int, device) -> torch.Tensor:
    return to_device(_nearest_index(out_size, in_size), device)


def resize_linear(x: torch.Tensor, sizes, axes, align_corners: bool = True) -> torch.Tensor:
    """Separable linear resize (bilinear/trilinear) along `axes`."""
    for size, axis in zip(sizes, axes):
        in_size = x.shape[axis]
        if size != in_size:
            m = _device_linear(size, in_size, align_corners, x.device, x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ m.T, -1, axis)
    return x


def resize_nearest(x: torch.Tensor, sizes, axes) -> torch.Tensor:
    """Nearest resize along `axes` (a row selection, exact in any dtype)."""
    for size, axis in zip(sizes, axes):
        in_size = x.shape[axis]
        if size != in_size:
            x = torch.index_select(x, axis, _device_nearest(size, in_size, x.device))
    return x


def upsample2d_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, fH, fW, C], align-corners bilinear."""
    _, h, w, _ = x.shape
    return resize_linear(x, (h * factor, w * factor), (1, 2))


def upsample2d_nearest(x: torch.Tensor, factor: int, axes=(1, 2)) -> torch.Tensor:
    """[B, H, W, C] -> [B, fH, fW, C], torch 'nearest' (each pixel repeated
    `factor` times); `axes=(2, 3)` for [B, C, H, W]."""
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    return resize_nearest(x, (h * factor, w * factor), axes)


def downsample2d_nearest(x: torch.Tensor, factor: int, axes=(1, 2)) -> torch.Tensor:
    """[B, H, W, C] nearest downsample by an integer factor (source pixel
    floor(dst * factor)); `axes=(2, 3)` for [B, C, H, W]."""
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    return resize_nearest(x, (h // factor, w // factor), axes)


def upsample3d_trilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, fD, fH, fW, C], align-corners trilinear."""
    _, d, h, w, _ = x.shape
    return resize_linear(x, (d * factor, h * factor, w * factor), (1, 2, 3))
