"""Affine-invariant dual-pixel metrics: WMAE, WRMSE, 1-Spearman
(counterpart of `dualpixelface_tpu/metrics/affine_dp.py`). `metrics` runs
in numpy on the host, as the JAX pack's does, and the benchmark measures
with it; `metrics_torch` is the counterpart of its on-device twin
`metrics_jax`, in float32 on the inputs' device, which the benchmark does
not call (as in JAX). A bf16 prediction is widened to float32 first.

Parity target: the Google dual_pixels metrics the reference runs through a
TensorFlow 2.3 detour (ref src/metric/affine_dp/metric.py:22-151,
logger.py:31-46). Re-implemented here in pure numpy — no TF dependency, no
framework boundary in the eval loop (SURVEY.md §7.2 step 7):

  * WMAE: 5 IRLS iterations; each solves a confidence-weighted 2-parameter
    least squares (pred -> depth affine fit) and reweights by 1/max(eps,|r|)
    (metric.py:22-44). The reference's tf.linalg.lstsq(fast=False) ignores
    its l2_regularizer, so a plain lstsq matches.
  * WRMSE: single weighted lstsq, residuals squared/clipped (metric.py:47-62).
  * Spearman: double-argsort ranks rescaled to [-1,1], weighted Pearson, max
    over sign, reported as 1-rho (metric.py:65-101,143).

Per-sample optional center-crop, averaged over the batch (metric.py:104-151).
"""
from __future__ import annotations

import numpy as np
import torch

from dualpixelface_tpu_torch.metrics import register_metric
from dualpixelface_tpu_torch.metrics.base import Benchmark
from dualpixelface_tpu_torch.ops.geometry import _wls_affine, inverse_depth
from dualpixelface_tpu_torch.utils import tensor2numpy


def _wls_affine_batched(pred: np.ndarray, depth: np.ndarray, w: np.ndarray):
    """Solve min_b || sqrt(w_b) * (s_b*pred_b + t_b - depth_b) ||^2 for every
    sample at once via the closed-form 2x2 normal equations. pred/depth/w are
    [B, N]; returns (s, t) each [B]. Matches np.linalg.lstsq on full-rank
    systems (the parity test pins the values); tiny eps guards degeneracy the
    way the reference's l2_regularizer would (ref metric.py:40)."""
    eps = 1e-12
    sw = w.sum(axis=1) + eps
    sx = (w * pred).sum(axis=1)
    sy = (w * depth).sum(axis=1)
    sxx = (w * pred * pred).sum(axis=1) + eps
    sxy = (w * pred * depth).sum(axis=1)
    det = sw * sxx - sx * sx
    det = np.where(np.abs(det) < eps, eps, det)
    s = (sw * sxy - sx * sy) / det
    t = (sxx * sy - sx * sxy) / det
    return s, t


def affine_inv_wmae(prediction: np.ndarray, depth: np.ndarray, depth_conf: np.ndarray,
                    irls_iters: int = 5, epsilon: float = 1e-3) -> np.ndarray:
    """Batched IRLS WMAE (ref metric.py:22-44). [B, N] inputs -> [B]."""
    irls_weight = np.ones_like(depth_conf)
    resid = np.zeros_like(depth_conf)
    for _ in range(irls_iters):
        s, t = _wls_affine_batched(prediction, depth, depth_conf * irls_weight)
        resid = np.abs(prediction * s[:, None] + t[:, None] - depth)
        irls_weight = 1.0 / np.maximum(epsilon, resid)
    return (depth_conf * resid).sum(axis=1) / depth_conf.sum(axis=1)


def affine_inv_wrmse(prediction: np.ndarray, depth: np.ndarray, depth_conf: np.ndarray) -> np.ndarray:
    """Batched weighted RMSE after one affine fit (ref metric.py:47-62)."""
    s, t = _wls_affine_batched(prediction, depth, depth_conf)
    resid_sq = np.minimum((prediction * s[:, None] + t[:, None] - depth) ** 2,
                          np.finfo(np.float32).max)
    return np.sqrt((depth_conf * resid_sq).sum(axis=1) / depth_conf.sum(axis=1))


def _pearson(x: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted Pearson correlation per batch row. [B, N] -> [B]."""
    w_sum = w.sum(axis=1, keepdims=True)
    e = lambda z: (w * z).sum(axis=1, keepdims=True) / w_sum
    mu_x, mu_y = e(x), e(y)
    var_x = e(x**2) - mu_x**2
    var_y = e(y**2) - mu_y**2
    cov = e(x * y) - mu_x * mu_y
    return (cov / np.sqrt(var_x * var_y))[:, 0]


def spearman_rank_correlation(x: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Batched double-argsort Spearman, max over prediction sign
    (ref metric.py:65-101). [B, N] inputs -> [B]."""
    rank = lambda z: np.argsort(np.argsort(z, axis=1), axis=1)
    n = x.shape[1]

    def cast_and_rescale(r):
        return (r - n // 2).astype(np.float64) / float(n // 2)

    x_rank = cast_and_rescale(rank(x))
    x_rank_neg = cast_and_rescale(rank(-x))
    y_rank = cast_and_rescale(rank(y))
    return np.maximum(_pearson(x_rank, y_rank, w), _pearson(x_rank_neg, y_rank, w))


def metrics(prediction: np.ndarray, gt_depth: np.ndarray, gt_depth_conf: np.ndarray,
            crop_height: int | None = None, crop_width: int | None = None):
    """[B, H, W] arrays -> [wmae, wrmse, 1-spearman] (ref metric.py:104-151).

    Fully vectorized across the batch: one closed-form weighted solve per IRLS
    iteration and one argsort pass for the whole batch, instead of the
    reference's per-sample TF lstsq loop — no host serialization in the eval
    loop."""

    def center_crop(images):
        if crop_height is not None and crop_width is not None:
            h, w = images.shape[1:3]
            oy, ox = (h - crop_height) // 2, (w - crop_width) // 2
            images = images[:, oy : oy + crop_height, ox : ox + crop_width]
        return images.astype(np.float32)

    batch = prediction.shape[0]
    p = center_crop(np.asarray(prediction)).reshape(batch, -1).astype(np.float64)
    d = center_crop(np.asarray(gt_depth)).reshape(batch, -1).astype(np.float64)
    c = center_crop(np.asarray(gt_depth_conf)).reshape(batch, -1).astype(np.float64)
    wmae = affine_inv_wmae(p, d, c)
    wrmse = affine_inv_wrmse(p, d, c)
    spearman = 1.0 - spearman_rank_correlation(p, d, c)
    return [float(wmae.mean()), float(wrmse.mean()), float(spearman.mean())]


def _ranks(z: torch.Tensor) -> torch.Tensor:
    """Each entry's rank along the last axis, ties in index order: the
    double argsort of `jnp.argsort`, which is stable. An unstable sort
    breaks ties in any order, and on a prediction with ties (a bf16 one is
    full of them) that moves 1-Spearman by ~4e-3."""
    return torch.argsort(torch.argsort(z, dim=-1, stable=True), dim=-1, stable=True)


def _pearson_torch(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Pearson correlation per row of [B, N] -> [B]."""
    ws = w.sum(-1)
    e = lambda z: (w * z).sum(-1) / ws
    mx, my = e(x), e(y)
    cov = e(x * y) - mx * my
    return cov / torch.sqrt((e(x * x) - mx**2) * (e(y * y) - my**2))


def metrics_torch(prediction: torch.Tensor, gt_depth: torch.Tensor, gt_depth_conf: torch.Tensor,
                  irls_iters: int = 5, epsilon: float = 1e-3) -> torch.Tensor:
    """[B, H, W] tensors -> float32 [wmae, wrmse, 1-spearman] averaged over
    the batch, on the inputs' device (counterpart of `metrics_jax`): each
    sample in float32, batched over B; the affine fits by `_wls_affine`'s
    2x2 normal equations with a 1e-8 ridge; WMAE by `irls_iters` IRLS
    steps reweighted by 1 / max(epsilon, |r|); WRMSE by one fit; Spearman
    by stable double-argsort ranks rescaled by (r - n//2) / (n//2), the max
    over the prediction's sign. No host sync: the result stays a tensor."""
    b = prediction.shape[0]
    p = prediction.reshape(b, -1).float()
    d = gt_depth.reshape(b, -1).float()
    c = gt_depth_conf.reshape(b, -1).float()

    w = torch.ones_like(c)
    resid = torch.zeros_like(c)
    for _ in range(irls_iters):
        s, t = _wls_affine(p, d, c * w)
        resid = (p * s[:, None] + t[:, None] - d).abs()
        w = 1.0 / resid.clamp_min(epsilon)
    wmae = (c * resid).sum(-1) / c.sum(-1)

    s, t = _wls_affine(p, d, c)
    resid_sq = ((p * s[:, None] + t[:, None] - d) ** 2).clamp_max(torch.finfo(torch.float32).max)
    wrmse = torch.sqrt((c * resid_sq).sum(-1) / c.sum(-1))

    half = p.shape[1] // 2
    resc = lambda r: (r - half).float() / float(half)
    xr, xrn, yr = resc(_ranks(p)), resc(_ranks(-p)), resc(_ranks(d))
    rho = torch.maximum(_pearson_torch(xr, yr, c), _pearson_torch(xrn, yr, c))
    return torch.stack([wmae, wrmse, 1.0 - rho], dim=-1).mean(0)


@register_metric("affine_dp")
class AffineDPBenchmark(Benchmark):
    keys = ("wmae", "wrmse", "spearman")

    def measure(self, results: dict, batch: dict, log: bool = True, target_type: str = "disp"):
        if target_type not in ("disp", "depth", "idepth"):
            raise ValueError(f"target_type {target_type!r}")
        pred = results["pred_depth"].float()
        if target_type not in ("disp", "idepth"):
            pred = inverse_depth(pred)
        target = batch[target_type] if target_type in ("disp", "idepth") else batch["idepth"]
        pred = tensor2numpy(pred[:, 0])
        target = tensor2numpy(target)
        mask = tensor2numpy(batch["mask"]) if "mask" in batch else np.ones_like(pred)
        conf = tensor2numpy(batch["conf"]) if batch.get("conf") is not None else mask
        data = metrics(pred, target, conf)
        if log:
            self.update(data)
        return data
