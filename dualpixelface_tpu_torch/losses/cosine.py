"""Masked cosine loss for surface normals (counterpart of
`dualpixelface_tpu/losses/cosine.py`).

Predicted normals [B, N, H, W, 3], gt [B, H, W, 3], both L2-normalised
(norm clamped at 1e-6). The reduction is the reference's: the masked mean
of 1 - p_c * g_c over the three COMPONENTS, i.e. 1 - cos / 3 per pixel, not
1 - cos.
"""
from __future__ import annotations

import torch

from dualpixelface_tpu_torch.losses import register_loss
from dualpixelface_tpu_torch.losses.common import loss_weights, masked_mean


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


@register_loss("cosine")
class CosineLoss:
    def __init__(self, option):
        self.option = option

    def __call__(self, results: dict, batch: dict, target_type=None) -> dict:
        pred = results["pred_normal"]  # [B, N, H, W, 3]
        num_pred = pred.shape[1]
        weights = loss_weights(self.option, num_pred, pred.dtype, pred.device)
        mask = (batch["mask"] > 0) if "mask" in batch else None
        gt = l2_normalize(batch["normal"])
        mask_c = None if mask is None else mask[..., None].expand(gt.shape)
        one = torch.ones((), dtype=pred.dtype, device=pred.device)
        loss = 0.0
        for i in range(num_pred):
            # min(max(.)) as jnp.clip: half the gradient at a bound
            sim = torch.minimum(torch.maximum(l2_normalize(pred[:, i]) * gt, -one), one)
            loss = loss + weights[i] * masked_mean(1.0 - sim, mask_c)
        return {"loss": loss}
