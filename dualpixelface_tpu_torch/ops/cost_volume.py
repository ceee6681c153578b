"""Disparity plane grids and soft-argmin regression (counterpart of
`dualpixelface_tpu/ops/cost_volume.py`)."""
from __future__ import annotations

import numpy as np
import torch


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


def soft_argmin(cost: torch.Tensor, disparities) -> tuple[torch.Tensor, torch.Tensor]:
    """cost [B, D, H, W] logits -> (disparity [B, H, W], probability
    [B, D, H, W]), computed in f32 and cast back to the cost dtype."""
    c32 = cost.float()
    prob = torch.exp(c32 - torch.amax(cost, dim=1, keepdim=True).float())
    prob = prob / prob.sum(dim=1, keepdim=True)
    dvec = torch.as_tensor(np.asarray(disparities, np.float32), device=cost.device).reshape(1, -1, 1, 1)
    disp = (prob * dvec).sum(dim=1)
    return disp.to(cost.dtype), prob.to(cost.dtype)
