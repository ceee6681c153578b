"""Disparity plane grids, integer-shift cost volumes and soft-argmin
regression (counterpart of `dualpixelface_tpu/ops/cost_volume.py`).

The dual-pixel disparity axis is H. The volumes take channels-first
features [B, C, H, W] and emit [B, C*, D, H, W], the layout the port's 3-D
convolutions take; each plane shifts the target by `int(d)` rows (toward
zero for negative planes, as the reference truncates) and keeps only the
rows the reference writes (`row_valid_mask`).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from dualpixelface_tpu_torch.ops.asm import shift_h_static
from dualpixelface_tpu_torch.utils.profiling import to_device


def costrange(mindisp: float, maxdisp: float, level: int) -> np.ndarray:
    """Quarter-resolution disparity plane centers."""
    return (
        np.arange(int(level)) * ((maxdisp / 4.0 - mindisp / 4.0) / float(level))
        + mindisp / 4.0
    )


def regression_disparities(mindisp: float, maxdisp: float, level: int, multiplier: int) -> np.ndarray:
    """Full-resolution soft-argmin bin centers."""
    n = int(multiplier * level)
    return np.arange(n) * ((maxdisp - mindisp) / float(n)) + mindisp


@functools.lru_cache(maxsize=256)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def row_valid_mask(h: int, disp: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[H, 1] mask of the rows the reference writes for integer shift
    `disp`: disp > 0 -> rows [0, H - disp); disp < 0 -> rows [-disp, H).
    Copied to the device once per (shape, shift); callers only read it."""
    rows = np.ones((h, 1), np.float32)
    if disp > 0:
        rows[h - disp:] = 0.0
    elif disp < 0:
        rows[:-disp] = 0.0
    return to_device(rows, device).to(dtype)


def _planes(ref: torch.Tensor, tar: torch.Tensor, disps: Sequence[float], plane) -> torch.Tensor:
    """Stack plane(ref, target shifted by int(d) rows, row mask) over the
    disparities at dim 2: [B, C, H, W] -> [B, C*, D, H, W]."""
    h = ref.shape[2]
    out = []
    for d in disps:
        k = int(d)
        out.append(plane(ref, shift_h_static(tar, k, axis=2), row_valid_mask(h, k, ref.dtype, ref.device)))
    return torch.stack(out, dim=2)


def subtraction_volume(ref: torch.Tensor, tar: torch.Tensor, disps: Sequence[float]) -> torch.Tensor:
    """StereoNet's volume: plane i = ref - tar[y + int(d_i)] on valid rows,
    zero elsewhere. [B, C, H, W] -> [B, C, D, H, W]."""
    return _planes(ref, tar, disps, lambda r, t, m: (r - t) * m)


def concat_volume_int(ref: torch.Tensor, tar: torch.Tensor, disps: Sequence[float]) -> torch.Tensor:
    """PSMNet's volume: plane i = concat(ref[y], tar[y + int(d_i)]) on valid
    rows. [B, C, H, W] -> [B, 2C, D, H, W]."""
    return _planes(ref, tar, disps, lambda r, t, m: torch.cat([r * m, t * m], dim=1))


def gwc_volume(ref: torch.Tensor, tar: torch.Tensor, disps: Sequence[float], num_groups: int) -> torch.Tensor:
    """GwcNet's volume: plane i = the NEGATIVE mean over each channel group
    of ref * tar[y + int(d_i)], on valid rows. [B, C, H, W] -> [B, G, D, H, W]."""
    b, c, h, w = ref.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")

    def plane(r, t, m):
        return -(r * t).reshape(b, num_groups, c // num_groups, h, w).mean(dim=2) * m

    return _planes(ref, tar, disps, plane)


def soft_argmin(cost: torch.Tensor, disparities) -> tuple[torch.Tensor, torch.Tensor]:
    """cost [B, D, H, W] logits -> (disparity [B, H, W], probability
    [B, D, H, W]), computed in f32 and cast back to the cost dtype."""
    c32 = cost.float()
    prob = torch.exp(c32 - torch.amax(cost, dim=1, keepdim=True).float())
    prob = prob / prob.sum(dim=1, keepdim=True)
    dvec = to_device(np.asarray(disparities, np.float32), cost.device).reshape(1, -1, 1, 1)
    disp = (prob * dvec).sum(dim=1)
    return disp.to(cost.dtype), prob.to(cost.dtype)
