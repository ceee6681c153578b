"""Folded multi-view photometric loss (counterpart of
`dualpixelface_tpu/losses/folded.py`; Google ICCV'19 "Learning Single
Camera Depth Estimation Using Dual-Pixels", reimplemented).

The target view's centre image, cropped batch-wise to the prediction by
grid sampling, against each selected reference view warped into it through
the predicted depth (pixel2cam, then cam2pixel with the views' K and P):
SSIM (3x3 VALID average pools) blended with Barron's general robust loss by
`weight_ssim`. As in the JAX package, the reference's two latent bugs are
repaired (the view count comes from batch["Ps"]; the abvalue is returned),
and the reference views are the first `num_neighbor_view` (default
`select_view`), not the reference's host shuffle.

Each mean is the global batch's (`losses.common.global_masked_means`): with
several ranks every rank computes the one-process loss. Training batches
hold no padding rows (the train pipeline drops the last partial batch), so
every row counts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dualpixelface_tpu_torch.losses import register_loss
from dualpixelface_tpu_torch.losses.common import global_masked_means, prepare_disparity_gt
from dualpixelface_tpu_torch.ops.resample import grid_sample


def avg_pool3_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID average pool of [B, H, W, C] -> [B, H-2, W-2, C]."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, conf=None) -> torch.Tensor:
    """(1 - SSIM) / 2 per pixel, clamped to [0, 1]; x, y [B, H, W, C]."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = avg_pool3_valid(x), avg_pool3_valid(y)
    sigma_x = avg_pool3_valid(x * x) - mu_x ** 2
    sigma_y = avg_pool3_valid(y * y) - mu_y ** 2
    sigma_xy = avg_pool3_valid(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    out = torch.clamp((1 - num / den) / 2, 0.0, 1.0)
    if conf is not None:
        out = out * avg_pool3_valid(conf)
    return out


def general_robust_loss(x: torch.Tensor, alpha: float, scale: float) -> torch.Tensor:
    """Barron's general robust loss, exact form; alpha and scale are config
    floats, so the case split is on the host."""
    ssx = (x / scale) ** 2
    if alpha == 2:
        return 0.5 * ssx
    if alpha == 0:
        return torch.log1p(torch.clamp_max(0.5 * ssx, 33e37))
    if np.isinf(alpha) and alpha < 0:
        return -torch.expm1(-0.5 * ssx)
    if np.isinf(alpha) and alpha > 0:
        return torch.expm1(torch.clamp_max(0.5 * ssx, 87.5))
    eps = float(np.finfo(np.float32).eps)
    beta_safe = max(eps, abs(alpha - 2.0))
    alpha_safe = np.sign(alpha) * max(eps, abs(alpha)) if alpha != 0 else eps
    return (beta_safe / alpha_safe) * ((ssx / beta_safe + 1.0) ** (0.5 * alpha) - 1.0)


def make_grid(b: int, h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """[B, 3, H, W] homogeneous pixel grid (x, y, 1)."""
    yg, xg = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xg, yg, torch.ones_like(xg)], 0)[None].expand(b, 3, h, w)


def batch_crop(feature: torch.Tensor, ch: int, cw: int, coords: torch.Tensor) -> torch.Tensor:
    """Batch-wise crop of feature [B, H, W, C] at per-sample offsets coords
    [B, 2] (x, y) by grid sampling. Normalised by (size - 1) and sampled
    with align_corners=False, as the JAX package (and the reference) do: a
    sub-pixel resample, not an integer crop."""
    b, h, w, _ = feature.shape
    ys = torch.arange(h, dtype=coords.dtype, device=feature.device)[None, :] + coords[:, 1:2]
    xs = torch.arange(w, dtype=coords.dtype, device=feature.device)[None, :] + coords[:, 0:1]
    yv = ys[:, :, None].expand(b, h, w)
    xv = xs[:, None, :].expand(b, h, w)
    grid = torch.stack([xv / (w - 1) * 2 - 1, yv / (h - 1) * 2 - 1], -1)
    return grid_sample(feature, grid, align_corners=False)[:, :ch, :cw]


def _inv(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse by LU, as `jnp.linalg.inv`: no check of the result,
    so no wait for the device (a singular matrix gives inf or NaN, as in
    JAX, where `torch.linalg.inv` would raise)."""
    return torch.linalg.inv_ex(m).inverse


def pixel2cam(grid: torch.Tensor, K: torch.Tensor, depth: torch.Tensor, mask=None) -> torch.Tensor:
    """Camera-frame points [B, 3, H, W] of the pixels at `depth` [B, H, W]."""
    b, h, w = depth.shape
    cam = torch.einsum("bij,bjn->bin", _inv(K), grid.reshape(b, 3, -1)).reshape(b, 3, h, w)
    if mask is not None:
        depth = depth * (mask > 0)
    return cam * depth[:, None]


def cam2pixel(tar3dpts, tarP, refP, refK, ref_h: int, ref_w: int) -> torch.Tensor:
    """Normalised reference-view coords [B, H, W, 2] of the target's camera
    points. Z is clamped at 1e-3; a coordinate out of [-1, 1] or not finite
    becomes 2.0 (a zero sample), through a `where` whose unselected branch
    passes no gradient, in JAX's order of operations."""
    b, _, h, w = tar3dpts.shape
    tar2ref = torch.einsum("bij,bjk->bik", refP, _inv(tarP))
    proj = torch.einsum("bij,bjk->bik", refK, tar2ref[:, :3])
    rot, trans = proj[:, :, :3], proj[:, :, 3:]
    ref = torch.einsum("bij,bjn->bin", rot, tar3dpts.reshape(b, 3, -1)) + trans
    x, y = ref[:, 0], ref[:, 1]
    z = torch.maximum(ref[:, 2], ref.new_full((), 1e-3))  # a fill on the device: no host copy, no wait
    xn = 2 * (x / z) / (ref_w - 1) - 1
    yn = 2 * (y / z) / (ref_h - 1) - 1
    bad_x = (xn > 1) | (xn < -1) | ~torch.isfinite(xn)
    bad_y = (yn > 1) | (yn < -1) | ~torch.isfinite(yn)
    xn = torch.where(bad_x, 2.0, xn)
    yn = torch.where(bad_y, 2.0, yn)
    return torch.stack([xn, yn], -1).reshape(b, h, w, 2)


@register_loss("folded")
class FoldedLoss:
    def __init__(self, option):
        self.option = option
        m = option.model
        self.num_neighbor_view = int(m.get("num_neighbor_view", m.get("select_view", 3)))
        self.weight_ssim = m.weight_ssim
        self.alpha = float(m.alpha)
        self.scale = float(m.scale)

    def __call__(self, results: dict, batch: dict, target_type: str = "disp") -> dict:
        if target_type not in ("disp", "depth", "idepth"):
            raise ValueError(f"target_type {target_type!r}")
        pred = results["pred_depth"]
        _, _, ab_value, mask = prepare_disparity_gt(self.option, results, batch, target_type)
        conf = batch.get("conf")

        ft = torch.promote_types(pred.dtype, torch.float32)  # f32, as in JAX (f64 for an f64 check)
        coords = batch["coords"].to(ft)
        tar_center = batch["raw_center"].to(ft)  # [B, H, W, 3]
        ref_centers = batch["centers"].to(ft)  # [B, N, H, W, 3]
        ref_ks, ref_ps = batch["Ks"], batch["Ps"]
        selected = range(min(ref_ps.shape[1], self.num_neighbor_view))

        b, ch, cw = pred.shape[0], pred.shape[2], pred.shape[3]
        ref_h, ref_w = ref_centers.shape[2], ref_centers.shape[3]
        grid = make_grid(b, ch, cw, pred.device, ft)
        ctarimg = batch_crop(tar_center, ch, cw, coords)
        tar3dpts = pixel2cam(grid, batch["K"], pred[:, 0], mask)
        conf_c = None if conf is None else conf[..., None]

        ssims, robust = [], []
        for i in selected:
            refcoord = cam2pixel(tar3dpts, batch["P"], ref_ps[:, i], ref_ks[:, i], ref_h, ref_w)
            warped = grid_sample(ref_centers[:, i], refcoord, align_corners=False)[:, :ch, :cw]
            ct, cw_img = ctarimg, warped
            if mask is not None:
                roimask = (mask > 0).to(ct.dtype)[..., None]
                ct, cw_img = ct * roimask, cw_img * roimask
            ssims.append(ssim(ct, cw_img, conf_c))
            rl = general_robust_loss(ct - cw_img, self.alpha, self.scale)
            robust.append(rl if conf_c is None else rl * conf_c)
        loss1 = global_masked_means(ssims, None)
        loss2 = global_masked_means(robust, None)
        l1 = sum(loss1) / len(loss1)
        l2 = sum(loss2) / len(loss2)
        loss = self.weight_ssim * l1 + (1 - self.weight_ssim) * l2
        return {"loss": loss, "abvalue": ab_value}
