"""Surface-normal angular metrics (counterpart of
`dualpixelface_tpu/metrics/normal_dp.py`; ref src/metric/normal_dp/metric.py:7-50).

Mean angular error (degrees) and angular RMSE between L2-normalized normals
under the mask. Channels-last normals [B, H, W, 3]; the masked reduction is
the static-shape weighted form (identical value to the reference's
boolean-index mean).
"""
from __future__ import annotations

import numpy as np

from dualpixelface_tpu_torch.metrics import register_metric
from dualpixelface_tpu_torch.metrics.base import Benchmark
from dualpixelface_tpu_torch.utils import tensor2numpy


def _normalize(v: np.ndarray, axis=-1, eps=1e-12) -> np.ndarray:
    n = np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), eps)
    return v / n


def cal_normal_acc(gt_n: np.ndarray, pred_n: np.ndarray, mask: np.ndarray):
    """Returns (mean angular error deg, angular RMSE deg).

    gt_n / pred_n: [B, H, W, 3]; mask: [B, H, W].
    """
    gt_n = _normalize(gt_n)
    pred_n = _normalize(pred_n)
    dot = np.clip(np.sum(gt_n * pred_n, axis=-1), -1.0, 1.0)
    ang = np.arccos(dot)  # radians, [B, H, W]
    m = (mask > 0).astype(np.float64)
    valid = np.maximum(m.sum(), 1.0)
    mean_deg = (ang * 180.0 / np.pi * m).sum() / valid
    rmse_deg = np.sqrt(((ang * m) ** 2).sum() / valid) * 180.0 / np.pi
    return mean_deg, rmse_deg


@register_metric("normal_dp")
class NormalDPBenchmark(Benchmark):
    keys = ("mean_angle_deg", "rmse_angle_deg")

    def measure(self, results: dict, batch: dict, log: bool = True, target_type: str = "disp"):
        pred = results["pred_normal"]
        if pred is None:
            raise KeyError("pred_normal")
        pred = tensor2numpy(pred)[:, 0]  # first scale, [B, H, W, 3]
        gt = tensor2numpy(batch["normal"])
        mask = tensor2numpy(batch["mask"]) if "mask" in batch else np.ones(pred.shape[:3])
        data = cal_normal_acc(gt, pred, mask)
        if log:
            self.update(data)
        return list(data)
