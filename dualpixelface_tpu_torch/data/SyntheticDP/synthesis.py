"""Synthetic dual-pixel sample synthesis (a copy of
`dualpixelface_tpu/data/SyntheticDP/synthesis.py`, shared by the in-memory
loader and the on-disk fixture writer).

Generates geometrically consistent RCV-schema samples without the 481 GB
benchmark (SURVEY.md §7.2 step 2): a smooth face-like depth surface inside an
elliptical mask, surface normals from the depth gradient, defocus disparity
via the affine model disp = a/depth + b with a real per-camera abvalue, and a
left/right DP pair rendered by shifting a random smooth texture by ∓disp/2
along the DP axis (H), so a stereo model can actually fit the data.
"""
from __future__ import annotations

import numpy as np

from dualpixelface_tpu_torch.data.calibration import ABVALUE_LIST, DEFAULT_METADATA


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scale: int = 8, channels: int | None = None):
    shape = (h // scale + 2, w // scale + 2) + (() if channels is None else (channels,))
    coarse = rng.standard_normal(shape).astype(np.float32)
    # bilinear upsample by separable linear interpolation
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)
    if channels is None:
        c00 = coarse[y0][:, x0]
        c01 = coarse[y0][:, x0 + 1]
        c10 = coarse[y0 + 1][:, x0]
        c11 = coarse[y0 + 1][:, x0 + 1]
        wy_ = wy[:, None]
        wx_ = wx[None, :]
    else:
        c00 = coarse[y0][:, x0, :]
        c01 = coarse[y0][:, x0 + 1, :]
        c10 = coarse[y0 + 1][:, x0, :]
        c11 = coarse[y0 + 1][:, x0 + 1, :]
        wy_ = wy[:, None, None]
        wx_ = wx[None, :, None]
    top = c00 * (1 - wx_) + c01 * wx_
    bot = c10 * (1 - wx_) + c11 * wx_
    return top * (1 - wy_) + bot * wy_


def synth_sample(index: int, h: int, w: int, camidx: int = 1, seed: int = 1234) -> dict:
    """One raw (pre-transform) sample in FaceDP value conventions.

    Returns dict with keys: left, right, center (uint8 [H,W,3]), depth, mask,
    disp, idepth (float [H,W]), normal (float [H,W,3]), K, P, abvalue [b, a],
    metadata, L.
    """
    rng = np.random.default_rng(seed * 100003 + index)

    # elliptical face mask
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2 + rng.uniform(-h * 0.05, h * 0.05), w / 2 + rng.uniform(-w * 0.05, w * 0.05)
    ry, rx = h * 0.38, w * 0.32
    ellipse = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
    mask = (ellipse < 1.0).astype(np.float32)

    # smooth face-like depth in mm around the benchmark's working distance
    base = 950.0 + rng.uniform(-80, 80)
    bump = np.maximum(0.0, 1.0 - ellipse)  # dome
    depth = base - 60.0 * bump + 12.0 * _smooth_noise(rng, h, w, scale=max(8, h // 12))
    depth = depth.astype(np.float64)
    depth = np.where(mask > 0, depth, 0.0)

    a, b = ABVALUE_LIST[camidx]
    m = mask > 0
    disp = np.divide(a, depth, where=m, out=np.zeros_like(depth)) + np.where(m, b, 0.0)
    fill = np.max(disp[m]) * 50.0
    disp = np.where(m, disp, fill).astype(np.float32)

    max_depth = depth[m].max()
    idepth = np.divide(max_depth, depth, where=m, out=np.zeros_like(depth)).astype(np.float32)
    depth = depth.astype(np.float32)

    # surface normals from the depth gradient (camera looks down -z)
    gy, gx = np.gradient(np.where(m, depth, base))
    normal = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = (normal * mask[..., None]).astype(np.float32)

    # DP pair: texture warped by ∓disp/2 rows
    tex = _smooth_noise(rng, h, w, scale=4, channels=3)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-6)
    tex = (0.15 + 0.7 * tex) * (0.35 + 0.65 * mask[..., None])

    def shift_rows(img, delta_map):
        rows = np.clip(yy + delta_map, 0, h - 1)
        r0 = np.floor(rows).astype(int)
        r1 = np.minimum(r0 + 1, h - 1)
        frac = (rows - r0)[..., None]
        cols = xx.astype(int)
        return img[r0, cols] * (1 - frac) + img[r1, cols] * frac

    d_small = np.where(m, disp, 0.0) * 0.5
    left = shift_rows(tex, d_small)
    right = shift_rows(tex, -d_small)
    center = 0.5 * (left + right)

    to_u8 = lambda x: np.clip(x * 255.0, 0, 255).astype(np.uint8)

    fx = fy = 7400.0
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1.0]], np.float32)
    P = np.eye(4, dtype=np.float32)

    return {
        "left": to_u8(left),
        "right": to_u8(right),
        "center": to_u8(center),
        "depth": depth,
        "mask": mask,
        "disp": disp,
        "idepth": idepth,
        "normal": normal,
        "K": K,
        "P": P,
        "abvalue": np.array([b, a], np.float32),
        "metadata": np.array(DEFAULT_METADATA, np.float32),
        "L": np.zeros((3, 3), np.float32),
    }
