"""Where K4's time goes on the card: its kernel beside builds of it that
leave one part out or change its occupancy.

    python3 -m dualpixelface_tpu_torch.tools.bench_k4_split

Builds `fused_softargmin_bwd.cu` (with `fsam.cuh` inlined) from the
package's `csrc/` once per variant with nvcc: as it is; with each exp2 an
FMA instead of the special-function unit (`no_exps`); with each pixel's
column shares kept in its own lane instead of handed to the neighbours by
shuffles (`no_shuffles`); and with the launch bound asking for 1 or 3
blocks of 256 per SM instead of 2 (`one_block`, `three_blocks`: the
registers ptxas may use, 255 or 80, and so the warps an SM can hold). The
variants' outputs are wrong by design, the last two's aside; they are
timed only. Each runs on the same seeded inputs at the train path's shape
([2, 8, 192, 144] bf16, 32 bins), launched through the C entry point with
the wrapper's own launch operands, on the device alone (`device_ms`, best
of three runs of ITERS launches), and is printed as one JSON line after
the card's name and power limit; a last line gives each part's cost, the
full kernel's time less the variant's. Needs a GPU and nvcc; builds into
`split_k4/` beside the kernels' build directory.
"""
from __future__ import annotations

import json

import torch

from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.kernels import fused_softargmin as fsam
from dualpixelface_tpu_torch.tools import build_variants, device_ms, require_cuda

SHAPE = (2, 8, 192, 144)  # the train path's coarse logits, batch 2 at 768x576
ITERS = 50
SEED = 0
VARIANTS = {"full": [], "no_exps": ["-DNO_EXPS"], "no_shuffles": ["-DNO_SHUFFLES"],
            "one_block": ["-DMIN_BLOCKS=1"], "three_blocks": ["-DMIN_BLOCKS=3"]}

# (text, replacement) pairs that put each part under its macro
PATCHES = [
    ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
     '#ifdef NO_EXPS\n  y = fmaf(x, 0.5f, 1.0f);\n#else\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n#endif'),
    ("    col[d] = fmaf(u.y, gd[d], col[d]) + __shfl_up_sync(0xffffffffu, u.z * gd[d], 1) +\n"
     "             __shfl_down_sync(0xffffffffu, u.x * gd[d], 1);",
     "#ifdef NO_SHUFFLES\n    col[d] = fmaf(u.y, gd[d], col[d]) + u.z * gd[d] + u.x * gd[d];\n#else\n"
     "    col[d] = fmaf(u.y, gd[d], col[d]) + __shfl_up_sync(0xffffffffu, u.z * gd[d], 1) +\n"
     "             __shfl_down_sync(0xffffffffu, u.x * gd[d], 1);\n#endif"),
    ("__launch_bounds__(THREADS, D <= 8 ? 2 : 1)",
     "__launch_bounds__(THREADS, D <= 8 ? MIN_BLOCKS : 1)"),
]


def patched() -> str:
    """K4's source with fsam.cuh inlined and each part under its macro;
    raises if a text to patch is not there exactly once."""
    source = (_build.CSRC / "fused_softargmin_bwd.cu").read_text()
    source = source.replace('#include "fsam.cuh"', (_build.CSRC / "fsam.cuh").read_text())
    source = "#ifndef MIN_BLOCKS\n#define MIN_BLOCKS 2\n#endif\n" + source
    for old, new in PATCHES:
        if source.count(old) != 1:
            raise SystemExit(f"bench_k4_split: the source no longer holds {old!r} once")
        source = source.replace(old, new)
    return source


def main() -> int:
    require_cuda("bench_k4_split")
    from dualpixelface_tpu_torch.profile_serving import _card

    libs = build_variants(patched(), _build.CSRC, "split_k4", VARIANTS)
    print(json.dumps({"card": _card(), "shape": list(SHAPE)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, d, h, w = SHAPE
    cost = (torch.randn(SHAPE, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
    g = torch.randn((b, 4 * h, 4 * w), generator=gen, device="cuda").to(torch.bfloat16)
    dvals = regression_disparities(-4, 12, d, 4)
    plan = fsam._plan(d, h, w, fsam._bin_values("bench_k4_split", cost, dvals, 4).tobytes(), cost.device)
    out = torch.empty_like(cost)
    times = {}
    for v, lib in libs.items():
        fn = lib.dpf_fused_softargmin_bwd
        fn.argtypes = fsam._BWD_ARGS
        args = (cost.data_ptr(), g.data_ptr(), out.data_ptr(), b, d, h, w, plan.ytap, plan.ywt, plan.xu, plan.bands,
                fsam.BAND_ROWS, plan.bins_ptr, 1, _build.current_stream(cost.device))

        def call():
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"bench_k4_split: launch failed with cudaError {rc}")

        call()
        torch.cuda.synchronize()
        times[v] = min(device_ms(call, ITERS) for _ in range(3))
        print(json.dumps({"variant": v, "device_ms": times[v]}), flush=True)
    print(json.dumps({"cost_ms": {v: times["full"] - t for v, t in times.items() if v != "full"}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
