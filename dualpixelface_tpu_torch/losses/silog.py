"""Scale-invariant log loss, BTS's (counterpart of
`dualpixelface_tpu/losses/silog.py`)."""
from __future__ import annotations

import torch

from dualpixelface_tpu_torch.losses import register_loss
from dualpixelface_tpu_torch.losses.common import global_masked_means, loss_weights, prepare_disparity_gt


@register_loss("silog")
class SilogLoss:
    """Per head i, 10 sqrt(E[d^2] - variance_focus E[d]^2) of d = w_i (log
    pred - log gt) over the mask, summed. With target_type "depth" the
    prediction and gt are `pred_depth` and `depth` themselves. Pixels out of
    the mask are set to 1 in both before the log, so the log never sees the
    invalid region's zeros (its weight 0 times log 0 would be NaN). The
    means are the global batch's (`global_masked_means`)."""

    def __init__(self, option):
        self.option = option
        self.variance_focus = option.model.variance_focus

    def __call__(self, results: dict, batch: dict, target_type: str = "disp") -> dict:
        if target_type not in ("disp", "depth", "idepth"):
            raise ValueError(f"target_type {target_type!r}")
        pred_, gt, ab_value, mask = prepare_disparity_gt(self.option, results, batch, target_type)
        if target_type == "depth":
            pred_, gt = results["pred_depth"], batch["depth"]
        weights = loss_weights(self.option, pred_.shape[1], pred_.dtype, pred_.device)
        m = None if mask is None else mask.to(pred_.dtype)
        gt_safe = gt if m is None else torch.where(m > 0, gt, 1.0)
        loss = 0.0
        for i in range(pred_.shape[1]):
            p_safe = pred_[:, i] if m is None else torch.where(m > 0, pred_[:, i], 1.0)
            d = weights[i] * (torch.log(p_safe) - torch.log(gt_safe))
            mean_d2, mean_d = global_masked_means([d * d, d], m)
            loss = loss + torch.sqrt(mean_d2 - self.variance_focus * mean_d ** 2) * 10.0
        return {"loss": loss, "abvalue": ab_value}
