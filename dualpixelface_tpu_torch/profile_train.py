"""The train-step rate of the port on the card, and where its time goes.

    python3 -m dualpixelface_tpu_torch.profile_train [--cell stereodpnet_plus|bench|trainer] [--iters 30] [--top 25]

Trains one of three cells on the JAX bench's batch recipe (`train_batch`),
H x W = 768 x 576, Adam at the configured rate, from seeded weights with
non-zero offset heads, after one warm-up step. Two (`CELLS`) run batch 2
under the bf16 policy (the run keys TRAIN_CELL):
  * `stereodpnet_plus` (the default): fast attention, windowed deform with
    the offset clamp, fused regression;
  * `bench`: the JAX bench's own train step (`bench.py:306-317`):
    `stereodpnet` with exact attention, the windowed deform without the
    offset clamp, fused regression.
The third, `trainer`, is the step of `chip_smoke.py` phase 10: the
committed run config TRAINER_RUN as it is (`stereodpnet_plus`, f32, Adam)
at its batch cut to TRAINER_BATCH, under `ops.precision.exact_f32` as an
f32 Trainer runs it; it also prints the device time per step summed by
kernel group (`KERNEL_GROUPS`).
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

from dualpixelface_tpu_torch.config import Configuration, load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.ops.precision import exact_f32, resolve_policy
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
# The trainer cell: the committed run config of chip_smoke.py phase 10 at
# that phase's batch.
TRAINER_RUN = "train_synthetic_stereodpnet_plus"
TRAINER_BATCH = 4
# Kernel groups of the trainer cell's step, each kernel in the first whose
# pattern its name matches: the port's hand-written kernels K1-K5 (both
# routes); cuDNN's convolutions and cuBLAS's products (forward and
# backward; the kernel list names the algorithms); the optimizer's
# multi-tensor updates; reductions and elementwise kernels (BatchNorm's
# plain torch ops among them: it has no kernel of its own); the rest
# (copies, memsets, gathers, resizes).
KERNEL_GROUPS = {
    "K1-K5": r"deform_fwd_|deform_bwd_|reduce_gw_kernel|cast_depad_kernel|fsam_|conv3d_3xtf32_kernel|conv3d_tc_kernel",
    "convolutions and products": r"conv|gemm|xmma|cudnn|cutlass|fft|wgrad|dgrad|fprop|winograd|implicit|sm\d\d_",
    "optimizer": r"multi_tensor_apply",
    "reductions": r"reduce|Reduce|norm",
    "elementwise": r"elementwise|vectorized|unrolled",
}


def cell_config(cell: str = "stereodpnet_plus"):
    """The merged config of train cell `cell`: its model and overrides, and
    the run keys TRAIN_CELL; for `trainer`, the run config TRAINER_RUN at
    TRAINER_BATCH."""
    if cell == "trainer":
        return Configuration(TRAINER_RUN, make_workspace=False, overrides={"batch_size": TRAINER_BATCH}).get_config()
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
    return {name: (gain * _blur(rng.standard_normal((b, h, w, 3)), sigma)).astype(np.float32)
            for name in ("left", "right", "center")}


def _blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """x [..., H, W, C] blurred along H and W by a Gaussian of `sigma`
    pixels (radius 4 sigma, mirrored edges)."""
    r = int(4 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    for axis in (x.ndim - 3, x.ndim - 2):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="symmetric")
        x = sum(k[j] * np.take(xp, np.arange(j, j + x.shape[axis]), axis=axis) for j in range(2 * r + 1))
    return x


def multiview_keys(rng, b: int, h: int, w: int, n: int = 3, depth: float = 1000.0, pad: int = 8) -> dict:
    """The FaceDP multi-view keys the folded loss reads, for a prediction of
    h x w at depths about `depth`, with a geometry whose warps move the
    pixels by a few pixels (some out of a reference view): the target's raw
    centre image and the references' ("raw_center", "centers") of
    (h + pad) x (w + pad), smooth texture in about [0, 1]; sub-pixel crop
    offsets "coords"; the target's "K" (focal 60 px, its centre shifted by
    the crop as the loader shifts it) and "P" (identity); each reference's
    "Ks" and "Ps": a rotation of up to 0.03 rad about y and about x, a
    translation of up to 0.08 `depth` in x and 0.05 `depth` in y."""
    rh, rw = h + pad, w + pad
    coords = rng.uniform(0.0, pad / 2, (b, 2)).astype(np.float32)
    f = 60.0
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = f
    k[:, 0, 2] = rw / 2 - coords[:, 0]
    k[:, 1, 2] = rh / 2 - coords[:, 1]
    k[:, 2, 2] = 1.0
    ks = np.tile(np.array([[f, 0, rw / 2], [0, f, rh / 2], [0, 0, 1]], np.float32), (b, n, 1, 1))
    ps = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    for i in range(b):
        for j in range(n):
            ay, ax = rng.uniform(-0.03, 0.03, 2)
            ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
            rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
            ps[i, j, :3, :3] = ry @ rx
            ps[i, j, :3, 3] = [rng.uniform(-0.08, 0.08) * depth, rng.uniform(-0.05, 0.05) * depth, 0.0]
    images = 0.5 + 2.0 * _blur(rng.standard_normal((b, n + 1, rh, rw, 3)), 1.5)
    return {"coords": coords, "raw_center": images[:, 0].astype(np.float32),
            "centers": images[:, 1:].astype(np.float32), "K": k,
            "P": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)), "Ks": ks, "Ps": ps}


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
    ap.add_argument("--cell", choices=(*CELLS, "trainer"), default="stereodpnet_plus")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a GPU")

    config = cell_config(args.cell)
    dtype = resolve_policy(config)
    if dtype == torch.float32:
        exact_f32()  # as an f32 Trainer runs
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
    groups = KERNEL_GROUPS if args.cell == "trainer" else None
    for line in device_profile(lambda: step(state, batch), reps=2, top=args.top, groups=groups):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
