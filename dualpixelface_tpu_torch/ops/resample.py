"""Bilinear grid sampling, channels-last (counterpart of
`dualpixelface_tpu/ops/resample.py`).

The folded multi-view loss aligns its batch-wise crops and warps the
reference views with it. Written as the JAX function's four-corner gather
with zero padding, so its autograd is JAX's derivative, kinks at the
`floor` included: the sample coordinates carry the loss's gradient with
respect to the depth.
"""
from __future__ import annotations

import torch


def grid_sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Sample `img` [B, H, W, C] at normalized coords `grid` [B, Ho, Wo, 2]
    (grid[..., 0] = x in [-1, 1], grid[..., 1] = y), bilinear, zeros outside.

    torch `F.grid_sample(mode='bilinear', padding_mode='zeros')` semantics:
    align_corners=True maps -1/1 to the pixel centres 0/N-1; False maps them
    to the image edges (pixel coords -0.5 / N-0.5)."""
    b, h, w, c = img.shape
    x, y = grid[..., 0], grid[..., 1]
    if align_corners:
        xs = (x + 1.0) * 0.5 * (w - 1)
        ys = (y + 1.0) * 0.5 * (h - 1)
    else:
        xs = ((x + 1.0) * w - 1.0) * 0.5
        ys = ((y + 1.0) * h - 1.0) * 0.5

    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    flat = img.reshape(b, h * w, c)

    def corner(yi, xi, wgt):
        ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        lin = torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long()  # [B, Ho, Wo]
        g = torch.gather(flat, 1, lin.reshape(b, -1, 1).expand(-1, -1, c)).reshape(lin.shape + (c,))
        return g * (wgt * ok.to(img.dtype))[..., None]

    return (corner(y0, x0, (1 - fy) * (1 - fx))
            + corner(y0, x0 + 1, (1 - fy) * fx)
            + corner(y0 + 1, x0, fy * (1 - fx))
            + corner(y0 + 1, x0 + 1, fy * fx))
