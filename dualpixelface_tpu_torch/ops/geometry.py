"""Dual-pixel geometry (counterpart of `dualpixelface_tpu/ops/geometry.py`).

The affine dual-pixel model is disp = a / depth + b, depth = a / (disp - b),
with `abvalue` stored as [b, a] per sample.
"""
from __future__ import annotations

import torch


def disp2depth(pred: torch.Tensor, abvalue: torch.Tensor) -> torch.Tensor:
    """Disparity -> depth. pred [B, N, H, W], abvalue [B, 2] ([b, a]);
    non-finite depths become 0."""
    if pred.ndim != 4 or abvalue.ndim != 2:
        raise ValueError(f"pred must be [B,N,H,W] and abvalue [B,2], got "
                         f"{tuple(pred.shape)} and {tuple(abvalue.shape)}")
    a = abvalue[:, 1].reshape(-1, 1, 1, 1).to(pred.dtype)
    b = abvalue[:, 0].reshape(-1, 1, 1, 1).to(pred.dtype)
    depth = a / (pred - b)
    return torch.where(torch.isfinite(depth), depth, torch.zeros((), dtype=pred.dtype, device=pred.device))
