"""Where T1's f32 route spends its time on the card: its 3xTF32 kernel
beside builds of it that leave one part out.

    python3 -m dualpixelface_tpu_torch.tools.bench_t1_split

Builds `conv3d_dslice_v2.cu` from the package's `csrc/`, with the
tensor-core tile of `conv_tc.cuh` inlined and patched, five times with
nvcc: as it is (`full`); without the products (`no_contraction`: no
`wgmma`; the A fragments and their split, which only the products read,
go with them); with one TF32 product a k slice instead of three
(`one_pass`: a_hi b_hi alone, a third of the tensor work); with the
fragments' split left out (`no_split`: hi and lo both the raw bits, the
same three products); and with x's copies zero-filled without a read
(`no_gathers`: each cp.async of the A tile copies 0 source bytes). The
variants' outputs are wrong by design; they are timed only. Each runs the
f32 entry on the same operands, packed once by `pack_conv3d_3xtf32`, at
the four sites of `bench_dslice_fold` (batch 4 at 768x576, the folded
BatchNorm and ReLU), timed with CUDA events, the best of three runs of
ITERS launches of the C entry point, one JSON line per site and variant
after the card's name and power limit; a last line sums the sites. What
a part costs is the full kernel's time less the time without it. Each
variant is built and timed in a process of its own (`--variants V`): in
one process, the second of two builds of this source loaded fails its
first launch with cudaErrorInvalidValue. Needs a GPU and nvcc; builds into
`split_t1/` beside the kernels' build directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import pack_conv3d_3xtf32
from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold
from dualpixelface_tpu_torch.tools import build_variants, cuda_ms, require_cuda

ITERS = 10
SEED = 0
VARIANTS = {"full": [], "no_contraction": ["-DNO_CONTRACTION"], "one_pass": ["-DONE_PASS"],
            "no_split": ["-DNO_SPLIT"], "no_gathers": ["-DNO_GATHERS"]}

_GUARDS = "".join(f"#ifdef {m}\n#define {m}_FLAG 1\n#else\n#define {m}_FLAG 0\n#endif\n"
                  for m in ("NO_CONTRACTION", "NO_GATHERS"))

# (text, replacement) pairs of conv_tc.cuh that put each part under its macro
PATCHES = [
    ("#pragma once\n", ""),
    ("    split_tf32(*reinterpret_cast<const float*>(tile + swizzle(r, k >> 2) + (k & 3) * 4), hi[q], lo[q]);\n",
     "#ifdef NO_SPLIT\n    hi[q] = lo[q] = *reinterpret_cast<const uint32_t*>(tile + swizzle(r, k >> 2) + (k & 3) * 4);\n"
     "#else\n    split_tf32(*reinterpret_cast<const float*>(tile + swizzle(r, k >> 2) + (k & 3) * 4), hi[q], lo[q]);\n"
     "#endif\n"),
    ("  Wgmma32<N>::mma(acc, al, dh);\n  Wgmma32<N>::mma(acc, ah, dl);\n",
     "#ifndef ONE_PASS\n  Wgmma32<N>::mma(acc, al, dh);\n  Wgmma32<N>::mma(acc, ah, dl);\n#endif\n"),
    ("for (int h = 0; h < 2; ++h) mma_3xtf32<N>(", "for (int h = 0; h < 2 * !NO_CONTRACTION_FLAG; ++h) mma_3xtf32<N>("),
    ("cp_async_ca(sa + swizzle(r0 + 16 * i, j), src, ok ? 16 : 0);",
     "cp_async_ca(sa + swizzle(r0 + 16 * i, j), src, ok && !NO_GATHERS_FLAG ? 16 : 0);"),
]


def patched() -> str:
    """T1's source with `conv_tc.cuh` inlined and each part under its
    macro; raises if a text to patch is not there exactly once."""
    header = (_build.CSRC / "conv_tc.cuh").read_text()
    for old, new in PATCHES:
        if header.count(old) != 1:
            raise SystemExit(f"bench_t1_split: conv_tc.cuh no longer holds {old!r} once")
        header = header.replace(old, new)
    source = (_build.CSRC / "conv3d_dslice_v2.cu").read_text()
    include = '#include "conv_tc.cuh"\n'
    if source.count(include) != 1:
        raise SystemExit("bench_t1_split: conv3d_dslice_v2.cu no longer includes conv_tc.cuh once")
    return source.replace(include, _GUARDS + header)


def variant_call(lib: ctypes.CDLL, xp, planes, ab, co: int):
    """A no-argument launch of the variant's f32 entry on operands already
    packed, into an output it allocates once."""
    b, d, h, w, cp = xp.shape
    out = torch.empty((b, d, h, w, co), dtype=torch.float32, device=xp.device)
    fn = lib.dpf_conv3d_k3_affine
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (xp.data_ptr(), planes.data_ptr(), ab.data_ptr(), out.data_ptr(), b, d, h, w, cp, co, 1, 0,
            _build.current_stream(xp.device))

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"bench_t1_split: launch failed with cudaError {rc}")

    call.keep = out
    return call


def time_variant(variant: str) -> float:
    """Build `variant` and time it at each site in this process (one JSON
    line each); returns the sum over the sites."""
    lib = build_variants(patched(), _build.CSRC, "split_t1", {variant: VARIANTS[variant]})[variant]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total = 0.0
    for label, shape, co in fold.SITES:
        inp = fold.site_inputs(shape, co, gen, torch.float32)
        xp, planes = pack_conv3d_3xtf32(inp["x"], inp["wmat"], co)
        call = variant_call(lib, xp, planes, inp["ab"], co)
        call()
        torch.cuda.synchronize()
        ms = min(cuda_ms(call, ITERS) for _ in range(3))
        total += ms
        print(json.dumps({"site": label, "variant": variant, "ms": ms}), flush=True)
        del inp, xp, planes, call
        torch.cuda.empty_cache()
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated variants to build and time")
    args = ap.parse_args()
    require_cuda("bench_t1_split")
    from dualpixelface_tpu_torch.profile_serving import _card

    wanted = args.variants.split(",")
    if not set(wanted) <= set(VARIANTS):
        raise SystemExit(f"bench_t1_split: variants are {tuple(VARIANTS)}, not {wanted}")
    if len(wanted) == 1:
        print(json.dumps({"variant": wanted[0], "sum_ms": time_variant(wanted[0])}), flush=True)
        return 0
    print(json.dumps({"card": _card(), "dtype": "float32", "sites": [s[0] for s in fold.SITES]}), flush=True)
    sums = {}
    for v in wanted:
        out = subprocess.run([sys.executable, "-m", __spec__.name, "--variants", v], capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"bench_t1_split: variant {v} failed:\n{out.stdout[-2000:]}{out.stderr[-3000:]}")
        print(out.stdout, end="", flush=True)
        sums[v] = json.loads(out.stdout.strip().splitlines()[-1])["sum_ms"]
    cost = {v: sums["full"] - t for v, t in sums.items() if v != "full"} if "full" in sums else None
    print(json.dumps({"dtype": "float32", "sum_ms": sums, "cost_ms": cost}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
