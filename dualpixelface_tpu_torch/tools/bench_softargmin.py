"""K3's and K4's device time on the card, in this tree or in another
checkout of the port (to set two versions side by side in one call).

    python3 -m dualpixelface_tpu_torch.tools.bench_softargmin [--root DIR]

Times the wrappers `fused_softargmin` (K3) at the serving path's shape
([4, 8, 192, 144] -> [4, 768, 576]) and `fused_softargmin_bwd` (K4) at the
train path's ([2, 8, 192, 144]), bf16, on seeded logits (scale 3) and
cotangents, 32 bins from -4 to 12. Each gets its device time (`device_ms`:
the union of the device intervals of ITERS calls, memsets and casts
included, without the host's dispatch) and its event time (`cuda_ms`: CUDA
events around ITERS calls, dispatch included), best of REPS runs, and its
bound (bytes, f32 operations, exps: `bound`). With `--root DIR` the
wrappers and kernels come from the checkout at DIR (its `csrc/`, built
into its own `build/`); the timing helpers are this tree's. Prints the
card's name and power limit, then one JSON line. Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
from dualpixelface_tpu_torch.tools import (
    PEAK_F32, PEAK_SFU, bound_ms, cuda_ms, device_ms, require_cuda)

SERVE_SHAPE = (4, 8, 192, 144)
TRAIN_SHAPE = (2, 8, 192, 144)
DISP = regression_disparities(-4, 12, 8, 4)
ITERS = 50
REPS = 3
SEED = 0


def work(kernel: str, shape, itemsize: int = 2) -> dict:
    """The least work of K3 or K4 at `shape` [B, D, h, w] (factor 4), as
    `bound` prices it: bytes (the coarse logits read once, the disparity
    written once; K4 reads the logits and the cotangent and writes the
    gradient), exps (one per bin and pixel) and f32 operations, an FMA
    counting two as the peak rate does. The operations per output pixel:
      - per plane, the separable interpolation, 3 along x (a multiply and
        an FMA) and 3 along y shared by the 4 pixels on the same coarse
        columns (0.75), then the shift, a max and a subtraction (2);
      - per bin, its 2-tap logit (3), then for K3 the sum of the exps and
        an FMA of each with its value (3); for K4 instead an FMA of each
        into the two planes' sums of w e and w dv e (8);
      - K3: one division; K4 per plane the plane sums' totals (2), its
        gradient g/sum (S1 - out S0) (3) and the transposed interpolation
        (4 along x, 4 along y shared by 4 pixels: 1), and per pixel the
        reciprocal, out and g/sum (3)."""
    b, d, h, w = shape
    npix = b * 16 * h * w
    if kernel == "K3":
        per_pixel = d * 5.75 + 4 * d * 6.0 + 1.0
        nbytes = b * d * h * w * itemsize + npix * itemsize
    else:
        per_pixel = d * (5.75 + 2.0 + 3.0 + 5.0) + 4 * d * 11.0 + 3.0
        nbytes = 2 * b * d * h * w * itemsize + npix * itemsize
    return {"bytes": nbytes, "flops_f32": npix * per_pixel, "exps": npix * 4.0 * d}


def bound(w: dict) -> tuple[float, str]:
    """`bound_ms` of a `work` dict: bytes, f32 operations, exps."""
    return bound_ms(w["bytes"], (w["flops_f32"], PEAK_F32), (w["exps"], PEAK_SFU))


def load_wrappers(root: str | None):
    """The module holding K3's and K4's wrappers, from this tree or, with
    `root`, from the checkout there (this tree's modules of the package are
    dropped from `sys.modules` first; the helpers imported above stay)."""
    if root is not None:
        for name in [m for m in sys.modules if m.split(".")[0] == "dualpixelface_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(Path(root).resolve()))
    mod = importlib.import_module("dualpixelface_tpu_torch.ops.kernels.fused_softargmin")
    if root is not None and Path(root).resolve() not in Path(mod.__file__).resolve().parents:
        raise SystemExit(f"bench_softargmin: loaded {mod.__file__}, not a module under {root}")
    return mod


def measure(fsam) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cost = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
    tcost = (torch.randn(TRAIN_SHAPE, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
    b, _, h, w = TRAIN_SHAPE
    g = torch.randn((b, 4 * h, 4 * w), generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"K3": (lambda: fsam.fused_softargmin(cost, DISP, 4), SERVE_SHAPE),
             "K4": (lambda: fsam.fused_softargmin_bwd(tcost, g, DISP, 4), TRAIN_SHAPE)}
    out = {}
    for k, (fn, shape) in calls.items():
        b_ms, b_by = bound(work(k, shape))
        dev = min(device_ms(fn, ITERS) for _ in range(REPS))
        out[k] = {"shape": list(shape), "device_ms": dev, "event_ms": min(cuda_ms(fn, ITERS) for _ in range(REPS)),
                  "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="another checkout of the port to take K3 and K4 from")
    args = ap.parse_args()
    require_cuda("bench_softargmin")
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fsam = load_wrappers(args.root)
    print(json.dumps({"tree": args.root or "this", "card": card, **measure(fsam)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
