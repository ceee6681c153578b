"""Result figure dumping (counterpart of `dualpixelface_tpu/utils/visualizer.py`).

The reference declares `src/utils/visualizer.py` as an empty stub and its
models carry a commented-out `save_result_fig_depth` call
(ref stereodpnet/mainmodel.py:145). This implements the working equivalent:
per-sample PNG panels of input / predicted disparity / gt depth / normals,
written under workspace/<model>/<ws>/output/figs/.

Pure PIL + numpy (no matplotlib dependency on the hot path).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from dualpixelface_tpu_torch.utils.file_manager import makedir_custom


def _colorize(x: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Normalize a scalar map to a simple viridis-like RGB uint8 image."""
    x = np.asarray(x, np.float64)
    valid = mask > 0 if mask is not None else np.isfinite(x)
    if valid.any():
        lo, hi = np.percentile(x[valid], [2, 98])
    else:
        lo, hi = 0.0, 1.0
    t = np.clip((x - lo) / max(hi - lo, 1e-9), 0, 1)
    # 3-stop gradient: dark blue -> teal -> yellow
    stops = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]], np.float64)
    idx = t * 2.0
    lo_i = np.clip(np.floor(idx).astype(int), 0, 1)
    frac = (idx - lo_i)[..., None]
    rgb = stops[lo_i] * (1 - frac) + stops[lo_i + 1] * frac
    if mask is not None:
        rgb = rgb * (mask > 0)[..., None]
    return rgb.astype(np.uint8)


def _denorm_img(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization for display."""
    mean = np.array([0.485, 0.456, 0.406])
    std = np.array([0.229, 0.224, 0.225])
    x = np.clip(img * std + mean, 0, 1)
    return (x * 255).astype(np.uint8)


def _normal_img(n: np.ndarray) -> np.ndarray:
    return (np.clip((n + 1) / 2, 0, 1) * 255).astype(np.uint8)


def save_result_fig_depth(option, results: dict, batch: dict, epoch: int, step: int, mode: str = "TEST"):
    """Dump a horizontal panel per sample (input | pred disp | gt depth
    [| pred normal | gt normal]); `results` and `batch` hold numpy arrays
    (`utils.tensor2numpy`)."""
    out_dir = makedir_custom(Path(option.output_path) / "figs")
    pred = np.asarray(results["pred_depth"])  # [B, N, H, W]
    b = pred.shape[0]
    for i in range(b):
        panels = []
        if "left" in batch:
            panels.append(_denorm_img(np.asarray(batch["left"][i])))
        mask = np.asarray(batch["mask"][i]) if "mask" in batch else None
        panels.append(_colorize(pred[i, 0], mask))
        if "depth" in batch:
            panels.append(_colorize(np.asarray(batch["depth"][i]), mask))
        if results.get("pred_normal") is not None:
            panels.append(_normal_img(np.asarray(results["pred_normal"][i, 0])))
        if "normal" in batch:
            panels.append(_normal_img(np.asarray(batch["normal"][i])))
        h = min(p.shape[0] for p in panels)
        w_tot = sum(p.shape[1] for p in panels)
        canvas = np.zeros((h, w_tot, 3), np.uint8)
        x0 = 0
        for p in panels:
            canvas[:, x0 : x0 + p.shape[1]] = p[:h]
            x0 += p.shape[1]
        name = f"{mode.lower()}_e{epoch:03d}_s{step:06d}_{i}.png"
        Image.fromarray(canvas).save(out_dir / name)
    return out_dir
