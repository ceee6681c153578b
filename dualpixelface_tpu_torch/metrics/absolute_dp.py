"""Absolute depth metrics at threshold 1.01 (counterpart of
`dualpixelface_tpu/metrics/absolute_dp.py`; ref src/metric/absolute_dp/).

abs_rel, abs_diff, sq_rel, rmse, rmse_log, a1/a2/a3 on masked pixels,
computed after disparity -> depth conversion with the batch abvalue
(ref absolute_dp/logger.py:40-47), the masked selection on the host in
numpy as the reference does (metric.py:5-31). A bf16 prediction is widened
to float32 first, where the JAX pack converts it and takes its log in
bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from dualpixelface_tpu_torch.metrics import register_metric
from dualpixelface_tpu_torch.metrics.base import Benchmark
from dualpixelface_tpu_torch.ops import geometry
from dualpixelface_tpu_torch.utils import tensor2numpy


def compute_errors_test_depth(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray, threshold: float):
    """Ref absolute_dp/metric.py:5-31, verbatim math."""
    gt = gt[mask > 0]
    pred = pred[mask > 0]
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < threshold).mean()
    a2 = (thresh < threshold**2).mean()
    a3 = (thresh < threshold**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_diff = np.mean(np.abs(gt - pred))
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return [abs_rel, abs_diff, sq_rel, rmse, rmse_log, a1, a2, a3]


@register_metric("absolute_dp")
class AbsoluteDPBenchmark(Benchmark):
    keys = ("abs_rel", "abs_diff", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    threshold = 1.01

    def measure(self, results: dict, batch: dict, log: bool = True, target_type: str = "disp"):
        if target_type not in ("disp", "depth", "idepth"):
            raise ValueError(f"target_type {target_type!r}")
        pred = results["pred_depth"].float()  # [B, N, H, W] disparity
        abvalue = batch["abvalue"] if "abvalue" in batch else results["abvalue"]
        if target_type in ("disp", "idepth"):
            pred = geometry.disp2depth(pred, torch.as_tensor(abvalue, device=pred.device))
        pred = tensor2numpy(pred)
        target = tensor2numpy(batch["depth"])
        mask = tensor2numpy(batch["mask"]) if "mask" in batch else np.ones_like(pred[:, 0])
        data = compute_errors_test_depth(target, pred[:, 0], mask, self.threshold)
        if log:
            self.update(data)
        return data
