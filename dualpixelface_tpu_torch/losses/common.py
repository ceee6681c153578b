"""Shared loss helpers (counterpart of `dualpixelface_tpu/losses/common.py`):
masked reductions without boolean indexing, and ground-truth preparation."""
from __future__ import annotations

import torch

from dualpixelface_tpu_torch.ops import geometry


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None, eps: float = 1e-8) -> torch.Tensor:
    """Mean over the elements where `mask` is set (all without a mask)."""
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp_min(m.sum(), eps)


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) with threshold beta."""
    a = diff.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def loss_weights(option, num_pred: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-head weights: [1.0] for a single prediction, else
    `option.model.loss_weight`, one per head."""
    if num_pred == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    w = torch.as_tensor(list(option.model.loss_weight), dtype=dtype, device=device)
    if w.shape[0] != num_pred:
        raise ValueError(f"loss_weight has {w.shape[0]} entries for {num_pred} predictions")
    return w


def prepare_disparity_gt(option, results: dict, batch: dict, target_type: str):
    """(pred_ [B, N, H, W], gt [B, H, W], abvalue [B, 2], mask or None).

    With `dataset.dp_conversion == 'least_square'`, or no `abvalue` in the
    batch, the affine dual-pixel parameters are regressed from the first
    head against the inverse gt depth (`geometry.regress_affine`, no
    gradient) and gt is the gt depth converted with them; otherwise the
    batch's abvalue and its disparity (or inverse depth) are taken."""
    pred = results["pred_depth"]
    mask = (batch["mask"] > 0) if "mask" in batch else None

    pred_ = pred if target_type in ("disp", "idepth") else geometry.inverse_depth(pred)
    if option.dataset.dp_conversion == "least_square" or "abvalue" not in batch:
        ab_value = geometry.regress_affine(pred[:, 0:1], batch["idepth"][:, None])
        gt = geometry.depth2disp(batch["depth"][:, None], ab_value)[:, 0]
    else:
        ab_value = batch["abvalue"]
        gt = batch["disp"] if target_type == "disp" else batch["idepth"]

    if batch.get("conf") is not None:
        pred_ = pred_ * batch["conf"][:, None]
        gt = gt * batch["conf"]
    return pred_, gt, ab_value, mask
