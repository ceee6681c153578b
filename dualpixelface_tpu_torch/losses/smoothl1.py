"""Per-head masked smooth-L1 disparity loss (counterpart of
`dualpixelface_tpu/losses/smoothl1.py`)."""
from __future__ import annotations

from dualpixelface_tpu_torch.losses import register_loss
from dualpixelface_tpu_torch.losses.common import loss_weights, masked_mean, prepare_disparity_gt, smooth_l1


@register_loss("smoothL1")
class SmoothL1Loss:
    def __init__(self, option):
        self.option = option

    def __call__(self, results: dict, batch: dict, target_type: str = "disp") -> dict:
        if target_type not in ("disp", "depth", "idepth"):
            raise ValueError(f"target_type {target_type!r}")
        pred_, gt, ab_value, mask = prepare_disparity_gt(self.option, results, batch, target_type)
        num_pred = pred_.shape[1]
        weights = loss_weights(self.option, num_pred, pred_.dtype, pred_.device)
        loss = 0.0
        for i in range(num_pred):
            loss = loss + weights[i] * masked_mean(smooth_l1(pred_[:, i] - gt), mask)
        return {"loss": loss, "abvalue": ab_value}
