"""The benchmark's one traffic generator: a mix file's parameters and a
seed in, a pool of host batches out. The same seed gives the same pool.

Views are smooth random texture (white noise blurred by a Gaussian of
`views.sigma_px` pixels, times `views.gain`): a real capture is smooth, and
on white-noise views the f32 train step's gradient jumps with rounding.
They are drawn on the device and brought to the host, where a user's
request starts. Serving batches carry the views, a pinhole K at
`camera.focal_px` centred in the image and the fixed affine dual-pixel
model `camera.abvalue` ([b, a]: disparity = a / depth + b). A mix with
`labels` (a train mix) adds the JAX bench's labels: depth uniform in
`labels.depth_range` per pixel, its disparity and inverse depth under
that model, random normals, a full mask and a third (centre) view.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def substream(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, traffic, the
    check's sample), so the uses draw independent numbers."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(1, np.uint64)[0] >> 1)


def smooth(noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """[N, H, W, C] blurred along H and W by a Gaussian of `sigma` pixels
    (radius 4 sigma, reflected edges)."""
    r = int(4 * sigma + 0.5)
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=noise.device, dtype=torch.float32) / sigma) ** 2)
    k = k / k.sum()
    n, h, w, c = noise.shape
    x = noise.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.reshape(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _views(mix: dict) -> tuple:
    return ("left", "right", "center") if "labels" in mix else ("left", "right")


def shapes(mix: dict) -> dict:
    """The shape of each array of a batch of the mix, as `pool` makes it."""
    b, h, w = mix["batch"], mix["height"], mix["width"]
    out = {name: (b, h, w, 3) for name in _views(mix)}
    out.update(K=(b, 3, 3), abvalue=(b, 2))
    if "labels" in mix:
        out.update({k: (b, h, w) for k in ("depth", "disp", "idepth", "mask")}, normal=(b, h, w, 3))
    return out


def pool(mix: dict, seed: int, device) -> list[dict]:
    """`mix["pool"]` distinct batches of `mix["batch"]` samples, numpy
    arrays on the host."""
    gen = torch.Generator(device=device).manual_seed(substream(seed, 1))
    n, b, h, w = mix["pool"], mix["batch"], mix["height"], mix["width"]
    labels = mix.get("labels")
    names = _views(mix)
    views = mix["views"]
    f = mix["camera"]["focal_px"]
    k = np.tile(np.array([[[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]], np.float32), (b, 1, 1))
    ab = np.tile(np.asarray([mix["camera"]["abvalue"]], np.float32), (b, 1))
    out = []
    for _ in range(n):
        noise = torch.randn((len(names) * b, h, w, 3), generator=gen, device=device)
        v = (views["gain"] * smooth(noise, views["sigma_px"])).reshape(len(names), b, h, w, 3).cpu().numpy()
        batch = {name: v[i] for i, name in enumerate(names)}
        batch.update(K=k.copy(), abvalue=ab.copy())
        if labels is not None:
            lo, hi = labels["depth_range"]
            depth = lo + (hi - lo) * torch.rand((b, h, w), generator=gen, device=device)
            disp = ab[:, 1].reshape(b, 1, 1) / depth.cpu().numpy() + ab[:, 0].reshape(b, 1, 1)
            depth = depth.cpu().numpy()
            batch.update(depth=depth, disp=disp.astype(np.float32), idepth=(depth.max() / depth).astype(np.float32),
                         mask=np.ones((b, h, w), np.float32),
                         normal=torch.randn((b, h, w, 3), generator=gen, device=device).cpu().numpy())
        out.append(batch)
    return out
