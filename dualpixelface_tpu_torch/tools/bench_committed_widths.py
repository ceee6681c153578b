"""K1-K4's device time at the committed widths, on both routes, in this
tree or in another checkout of the port (to set two versions side by side
in one call: parent, change, change, parent).

    python3 -m dualpixelface_tpu_torch.tools.bench_committed_widths [--root DIR]

The widths the committed configs run (`inplanes` 32, `level` 8): K1 at Cin
35 and 64, Co 64, windowed, at the serving shape [4, 4, 192, 144] in bf16
and the trainer's batch 4 in f32; K2 the same at the train shape
[2, 4, 192, 144] in bf16 and the trainer's [4, 4, 192, 144] in f32; K3 at
[4, 8, 192, 144] and K4 at [2, 8, 192, 144] (K4 at 4 in f32), 32 bins from
-4 to 12. Each call's device time (`device_ms`: the union of the device
intervals of ITERS calls, the wrappers' packing, memsets and casts
included, without the host's dispatch), best of REPS, after WARM_S
seconds of back-to-back products (a fresh process on an idle card read
K3 and K4 ~30% faster than the processes after it in one call, so every
process starts from a loaded card); the SM clock (`nvidia-smi`) before
and after. With `--root DIR`
the wrappers and kernels come from the checkout at DIR (its `csrc/`, built
into its own `build/`); the timing helpers are this tree's. Prints the
card's name and power limit, then one JSON line. Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
from dualpixelface_tpu_torch.tools import device_ms, require_cuda

CINS = (35, 64)
CO = 64
SERVE, TRAIN, TRAINER = 4, 2, 4  # batches: serving, the bf16 train cell, the f32 trainer
PLANE = (192, 144)  # the ANM's and the regression's coarse plane at 768x576
DISP = regression_disparities(-4, 12, 8, 4)
ITERS = 10
REPS = 5
WARM_S = 5.0
SEED = 0


def load(root: str | None):
    """K1/K2's and K3/K4's wrapper modules, from this tree or, with `root`,
    from the checkout there (this tree's modules of the package are dropped
    from `sys.modules` first; the helpers imported above stay), their
    kernels built."""
    if root is not None:
        for name in [m for m in sys.modules if m.split(".")[0] == "dualpixelface_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(Path(root).resolve()))
    mods = [importlib.import_module(f"dualpixelface_tpu_torch.ops.kernels.{m}")
            for m in ("deform_fused", "fused_softargmin", "_build")]
    for mod in mods:
        if root is not None and Path(root).resolve() not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"bench_committed_widths: loaded {mod.__file__}, not a module under {root}")
    mods[2].build(("deform_conv3d", "deform_conv3d_bwd", "fused_softargmin", "fused_softargmin_bwd"))
    return mods[:2]


def warm_up(seconds: float) -> None:
    """Back-to-back bf16 products for `seconds`: the card's clocks settle
    under load before anything is timed."""
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def measure(df, fsam) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}

    def best(fn):
        return min(device_ms(fn, ITERS) for _ in range(REPS))

    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for cin in CINS:
            for k, b in (("K1", SERVE if dtype == torch.bfloat16 else TRAINER),
                         ("K2", TRAIN if dtype == torch.bfloat16 else TRAINER)):
                shape = (b, 4) + PLANE
                x = torch.randn(shape + (cin,), generator=gen, device="cuda").to(dtype)
                off = (torch.randn(shape + (81,), generator=gen, device="cuda") * 2.0).to(dtype)
                w = (torch.randn((3, 3, 3, cin, CO), generator=gen, device="cuda") / math.sqrt(27 * cin)).to(dtype)
                bias = torch.randn((CO,), generator=gen, device="cuda").to(dtype)
                if k == "K1":
                    fn = lambda: df.deform_conv3d_fused(x, off, w, bias, aperture=True)  # noqa: E731
                else:
                    g = torch.randn(shape + (CO,), generator=gen, device="cuda").to(dtype)
                    fn = lambda: df.deform_conv3d_bwd(x, off, w, bias, g, aperture=True)  # noqa: E731
                out[f"{k}_{dname}_cin{cin}"] = {"shape": list(shape) + [cin], "device_ms": best(fn)}
                torch.cuda.empty_cache()
        for k, b in (("K3", SERVE), ("K4", TRAIN if dtype == torch.bfloat16 else TRAINER)):
            cost = (torch.randn((b, 8) + PLANE, generator=gen, device="cuda") * 3.0).to(dtype)
            if k == "K3":
                fn = lambda: fsam.fused_softargmin(cost, DISP, 4)  # noqa: E731
            else:
                g = torch.randn((b, 4 * PLANE[0], 4 * PLANE[1]), generator=gen, device="cuda").to(dtype)
                fn = lambda: fsam.fused_softargmin_bwd(cost, g, DISP, 4)  # noqa: E731
            out[f"{k}_{dname}"] = {"shape": list(cost.shape), "device_ms": best(fn)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="another checkout of the port to take K1-K4 from")
    args = ap.parse_args()
    require_cuda("bench_committed_widths")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    df, fsam = load(args.root)
    warm_up(WARM_S)
    before = sm_clock()
    res = measure(df, fsam)
    print(json.dumps({"tree": args.root or "this", "card": card, "sm_clock": [before, sm_clock()], **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
