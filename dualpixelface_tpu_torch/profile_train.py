"""The train-step rate of the port on the card, and where its time goes.

    python3 -m dualpixelface_tpu_torch.profile_train [--cell stereodpnet_plus|bench] [--iters 30] [--top 25]

Trains one of two cells (`CELLS`), batch 2 under the bf16 policy (the run
keys TRAIN_CELL), on the JAX bench's batch recipe (`train_batch`),
H x W = 768 x 576, Adam at the configured rate, from seeded weights with
non-zero offset heads, after one warm-up step:
  * `stereodpnet_plus` (the default): fast attention, windowed deform with
    the offset clamp, fused regression;
  * `bench`: the JAX bench's own train step (`bench.py:306-317`):
    `stereodpnet` with exact attention, the windowed deform without the
    offset clamp, fused regression.
It prints, as JSON lines:
  * the train rate (`profile_serving.timed` over --iters steps) and the
    peak device memory of a step;
  * each phase's device time in one step: the forward's top-level stages
    (CUDA events around the model's modules; the regression is the span
    between aggregation and the ANM), the losses, the backward and the
    optimizer update;
  * the device's busy time and idle share, and the top kernels by device
    time (per step), from torch.profiler over two steps.
Requires a GPU; it does not run on the CPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.ops.precision import resolve_policy
from dualpixelface_tpu_torch.profile_serving import _card, device_profile, stage_times, timed
from dualpixelface_tpu_torch.serve import seeded_state_dict
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step

H, W = 768, 576
# The run keys of both train cells: batch 2 under the bf16 policy, on the
# JAX bench's batch recipe.
TRAIN_CELL = {"precision": "bf16", "batch_size": 2}
# Each cell's model config and its overrides: the `stereodpnet_plus` cell
# (fast attention, offset clamp) and the JAX bench's train step (`bench`:
# `stereodpnet`, exact attention, windowed deform, no offset clamp).
CELLS = {"stereodpnet_plus": ("stereodpnet_plus", {}),
         "bench": ("stereodpnet", {"deform_impl": "pallas", "fused_regression": True})}


def cell_config(cell: str = "stereodpnet_plus"):
    """The merged config of train cell `cell`: its model and overrides, and
    the run keys TRAIN_CELL."""
    model, overrides = CELLS[cell]
    return load_config(model, model_overrides=overrides, run_overrides=TRAIN_CELL)


def train_batch(b: int, h: int, w: int, seed: int = 0) -> dict:
    """A training batch of the JAX package's bench recipe
    (`bench.make_bench_batch`): random views, depth uniform in [800, 1200],
    the disparity and inverse depth of a fixed affine dual-pixel model,
    random normals, a full mask, a pinhole K at f = 7400 px."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(800, 1200, (b, h, w)).astype(np.float32)
    ab = np.tile(np.array([[32.98, -26996.49]], np.float32), (b, 1))
    disp = (ab[:, 1:2, None] / depth + ab[:, 0:1, None]).astype(np.float32)
    return {
        "left": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "right": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "center": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "depth": depth,
        "mask": np.ones((b, h, w), np.float32),
        "disp": disp,
        "idepth": (depth.max() / depth).astype(np.float32),
        "normal": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "K": np.tile(np.array([[[7400.0, 0, w / 2], [0, 7400.0, h / 2], [0, 0, 1]]], np.float32), (b, 1, 1)),
        "abvalue": ab,
    }


def smooth_views(b: int, h: int, w: int, seed: int, sigma: float = 2.0, gain: float = 4.0) -> dict:
    """The three views ("left", "right", "center") as smooth random
    texture: per view, in that order, white noise [b, h, w, 3] from
    `default_rng(seed)` blurred along H and W by a Gaussian of `sigma`
    pixels (radius 4 sigma, mirrored edges: scipy.ndimage.gaussian_filter's
    kernel), times `gain`, as float32. A train step at a trained point is
    well conditioned on such views, where white-noise views make its f32
    gradient jump with rounding."""
    rng = np.random.default_rng(seed)
    r = int(4 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    views = {}
    for name in ("left", "right", "center"):
        x = rng.standard_normal((b, h, w, 3))
        for axis in (1, 2):
            pad = [(0, 0)] * 4
            pad[axis] = (r, r)
            xp = np.pad(x, pad, mode="symmetric")
            x = sum(k[j] * np.take(xp, np.arange(j, j + x.shape[axis]), axis=axis) for j in range(2 * r + 1))
        views[name] = (gain * x).astype(np.float32)
    return views


def phase_times(step, state, batch) -> dict:
    """Device ms of one step's phases: the forward's stages, then the
    losses, the backward and the update (CUDA events at the step's marks)."""
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    out = stage_times(state.model, lambda: step(state, batch, mark=mark))
    out["forward"] = events["forward"].elapsed_time(events["loss"])
    for a, b in (("loss", "backward"), ("backward", "update"), ("update", "end")):
        out[a] = events[a].elapsed_time(events[b])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=tuple(CELLS), default="stereodpnet_plus")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a GPU")

    config = cell_config(args.cell)
    dtype = resolve_policy(config)
    state = create_train_state(config, steps_per_epoch=100, state_dict=seeded_state_dict(config), device="cuda")
    step = make_train_step(state.model, loss_selector(config), dtype)
    batch = train_batch(config.batch_size, H, W)
    step(state, batch)  # warm-up: cuDNN plans, the allocator, the kernels' builds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rate = timed(lambda b: step(state, b)[1], [batch] * args.iters)
    print(json.dumps({"train": rate, "cell": args.cell, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": _card(), "batch": config.batch_size, "hw": [H, W],
                      "dtype": str(dtype).removeprefix("torch.")}), flush=True)
    print(json.dumps({"phase_ms": phase_times(step, state, batch)}), flush=True)
    for line in device_profile(lambda: step(state, batch), reps=2, top=args.top):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
