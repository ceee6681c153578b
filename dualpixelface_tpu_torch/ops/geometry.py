"""Dual-pixel geometry (counterpart of `dualpixelface_tpu/ops/geometry.py`).

The affine dual-pixel model is disp = a / depth + b, depth = a / (disp - b),
with `abvalue` stored as [b, a] per sample. `regress_affine` fits it per
sample by IRLS with soft-L1 weights, without gradient.
"""
from __future__ import annotations

import torch


def disp2depth(pred: torch.Tensor, abvalue: torch.Tensor) -> torch.Tensor:
    """Disparity -> depth. pred [B, N, H, W], abvalue [B, 2] ([b, a]);
    non-finite depths become 0."""
    _check(pred, abvalue)
    a = abvalue[:, 1].reshape(-1, 1, 1, 1).to(pred.dtype)
    b = abvalue[:, 0].reshape(-1, 1, 1, 1).to(pred.dtype)
    depth = a / (pred - b)
    return _finite_or(depth, 0.0)


def _finite_or(x: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full((), fill, dtype=x.dtype, device=x.device))


def _check(pred, abvalue=None):
    if pred.ndim != 4 or (abvalue is not None and abvalue.ndim != 2):
        raise ValueError(f"pred must be [B,N,H,W] and abvalue [B,2], got {tuple(pred.shape)}"
                         + ("" if abvalue is None else f" and {tuple(abvalue.shape)}"))


def depth2disp(pred: torch.Tensor, abvalue: torch.Tensor) -> torch.Tensor:
    """Depth -> disparity: a / depth + b; non-finite values become -100."""
    _check(pred, abvalue)
    a = abvalue[:, 1].reshape(-1, 1, 1, 1).to(pred.dtype)
    b = abvalue[:, 0].reshape(-1, 1, 1, 1).to(pred.dtype)
    return _finite_or(a / pred + b, -100.0)


def inverse_depth(pred: torch.Tensor) -> torch.Tensor:
    """1 / depth, non-finite values 0. pred [B, N, H, W]."""
    _check(pred)
    return _finite_or(1.0 / pred, 0.0)


def _wls_affine(x, y, w):
    """Per-sample weighted least squares y ~= s*x + t over the last axis
    (closed-form 2x2 normal equations with a 1e-8 ridge). Returns (s, t)."""
    eps = 1e-8
    sw = w.sum(-1) + eps
    sx = (w * x).sum(-1)
    sy = (w * y).sum(-1)
    sxx = (w * x * x).sum(-1) + eps
    sxy = (w * x * y).sum(-1)
    det = sw * sxx - sx * sx
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    return (sw * sxy - sx * sy) / det, (sxx * sy - sx * sxy) / det


@torch.no_grad()
def regress_affine(pred: torch.Tensor, gt: torch.Tensor, irls_iters: int = 10, f_scale: float = 0.1) -> torch.Tensor:
    """Robust per-sample affine fit pred ~= a * gt + b, as abvalue [B, 2] =
    [b, a] in pred's dtype, without gradient (the reference's no_grad
    block). Plain WLS, then `irls_iters` IRLS steps with the soft-L1 weights
    1 / sqrt(1 + (r / f_scale)^2); pixels with gt <= 0 weigh 0.
    pred, gt [B, 1, H, W]."""
    if pred.ndim != 4 or gt.ndim != 4:
        raise ValueError(f"pred and gt must be [B,1,H,W], got {tuple(pred.shape)} and {tuple(gt.shape)}")
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    g = gt.reshape(b, -1).float()
    valid = (g > 0).float()
    s, t = _wls_affine(g, p, valid)
    for _ in range(irls_iters):
        r = (s[:, None] * g + t[:, None] - p) / f_scale
        s, t = _wls_affine(g, p, valid / torch.sqrt(1.0 + r * r))
    return torch.stack([t, s], dim=1).to(pred.dtype)
