"""Where K1's time goes on the card: its tensor-core kernels beside builds
of them that leave one part out, and the wrapper's packing alone.

    python3 -m dualpixelface_tpu_torch.tools.bench_k1_split [--dtype float32]

Builds `deform_conv3d.cu` from the package's `csrc/` four times with nvcc:
as it is; without the contraction (no `wgmma`; in f32 the split fragments,
which only the contraction reads, go with it); with every corner load of x
reading the corner-0 row of its voxel (the same addresses a lane just
read, so the loads hit L1: what is left of the gather without its traffic
beyond L1); and with no loads of x at all (a value made from the index).
With `--dtype float32`, a fifth build sums each sample with FMA (the
kernel sums it as a product then a sum, each rounded, to equal the plain
version's samples bit for bit): what that exactness costs. Both routes
are patched in the one source. The variants' outputs are wrong by design
(the fifth's by an ulp); they are timed only. Each runs the route of `--dtype` on the
same seeded inputs, aperture on, Cin 35 and 64: bf16 (the default,
`dpf_deform_conv3d_tc`) at the serving path's [4, 4, 192, 144, Cin], f32
(the 3xTF32 `dpf_deform_conv3d_3xtf32`) at the trainer's batch 4, the
same shape. Each is timed with CUDA events, the best of three runs of
ITERS launches of the C entry point on operands packed once, and printed
as one JSON line after the card's name and power limit, as is the route's
packing alone (`pack_deform_fwd`, `pack_deform_fwd_3xtf32`); a last line
sums the two Cin. What a part costs is the full kernel's time less the
time without it. Needs a GPU and nvcc; builds into `split_k1/` beside the
kernels' build directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math

import torch

from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.kernels.deform_fused import CO, KTAPS, pack_deform_fwd, pack_deform_fwd_3xtf32
from dualpixelface_tpu_torch.tools import build_variants, cuda_ms, require_cuda

SHAPE = (4, 4, 192, 144)  # the serving path's ANM volume, batch 4 at 768x576; the trainer's in f32
CINS = (35, 64)
ITERS = 10
SEED = 0
VARIANTS = {"full": [], "no_contraction": ["-DNO_CONTRACTION"], "l1_gathers": ["-DL1_GATHERS"],
            "no_gathers": ["-DNO_GATHERS"]}
F32_VARIANTS = {"fma_samples": ["-DFMA_SAMPLES"]}  # the f32 route's only

_GUARDS = ("#ifdef NO_CONTRACTION\n#define NO_CONTRACTION_FLAG 1\n#else\n#define NO_CONTRACTION_FLAG 0\n#endif\n"
           "#if defined(NO_GATHERS)\n"
           "#define K1_X_LOAD(q) make_uint4(0x3f803f80u ^ (unsigned)(id[q] & 7), 0x3f803f80u, 0x3f803f80u, 0x3f803f80u)\n"
           "#define K1_X_LOAD4(q) make_float4(1.0f + (float)(id[q] & 7), 1.0f, 1.0f, 1.0f)\n"
           "#elif defined(L1_GATHERS)\n"
           "#define K1_X_LOAD(q) __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[0] * ldx + cb + c))\n"
           "#define K1_X_LOAD4(q) __ldg(reinterpret_cast<const float4*>(x + (size_t)id[0] * ldx + cb + c))\n"
           "#else\n#define K1_X_LOAD(q) __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * ldx + cb + c))\n"
           "#define K1_X_LOAD4(q) __ldg(reinterpret_cast<const float4*>(x + (size_t)id[q] * ldx + cb + c))\n#endif\n")

# (text, replacement) pairs that put each part under its macro
PATCHES = [
    ('#include "tma.cuh"\n', '#include "tma.cuh"\n' + _GUARDS),
    ("xr[q] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * ldx + cb + c));", "xr[q] = K1_X_LOAD(q);"),
    ("#pragma unroll\n    for (int kk = 0; kk < KP / 16; ++kk) tc::Wgmma<64, 0, 1>::mma(",
     "#ifndef NO_CONTRACTION\n#pragma unroll\n    for (int kk = 0; kk < KP / 16; ++kk) tc::Wgmma<64, 0, 1>::mma("),
    ("tc::desc(sb + kk * 2048));\n", "tc::desc(sb + kk * 2048));\n#endif\n"),
    # the f32 route's kernel, in the same source
    ("xr[q] = __ldg(reinterpret_cast<const float4*>(x + (size_t)id[q] * ldx + cb + c));", "xr[q] = K1_X_LOAD4(q);"),
    ("        tc::mma_3xtf32<CO>(acc, ", "        if (!NO_CONTRACTION_FLAG) tc::mma_3xtf32<CO>(acc, "),
    ("  s.x = __fadd_rn(s.x, __fmul_rn(w, v.x));\n",
     "#ifdef FMA_SAMPLES\n  s.x = fmaf(w, v.x, s.x);\n  s.y = fmaf(w, v.y, s.y);\n  s.z = fmaf(w, v.z, s.z);\n"
     "  s.w = fmaf(w, v.w, s.w);\n  return;\n#endif\n  s.x = __fadd_rn(s.x, __fmul_rn(w, v.x));\n"),
]
SYMBOLS = {"bfloat16": "dpf_deform_conv3d_tc", "float32": "dpf_deform_conv3d_3xtf32"}
PACK = {"bfloat16": pack_deform_fwd, "float32": pack_deform_fwd_3xtf32}


def patched(source: str) -> str:
    """K1's source with each part under its macro; raises if a text to
    patch is not there exactly once."""
    for old, new in PATCHES:
        if source.count(old) != 1:
            raise SystemExit(f"bench_k1_split: the source no longer holds {old!r} once")
        source = source.replace(old, new)
    return source


def variant_call(lib: ctypes.CDLL, xp, off, wpk, bias, c: int):
    """A no-argument launch of the variant's C entry point (the route of
    xp's dtype) on operands already packed, into an output it allocates
    once."""
    b, d, h, w, cp = xp.shape
    out = torch.empty((b, d, h, w, CO), dtype=xp.dtype, device=xp.device)
    fn = getattr(lib, SYMBOLS[str(xp.dtype).removeprefix("torch.")])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (xp.data_ptr(), off.data_ptr(), wpk.data_ptr(), bias.data_ptr(), out.data_ptr(), b, d, h, w, c, cp, CO,
            1, _build.current_stream(xp.device))

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"bench_k1_split: launch failed with cudaError {rc}")

    call.keep = out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=tuple(SYMBOLS), default="bfloat16",
                    help="the route to split: bf16, or the f32 route (3xTF32) at the trainer's batch 4")
    args = ap.parse_args()
    require_cuda("bench_k1_split")
    from dualpixelface_tpu_torch.profile_serving import _card

    variants = VARIANTS | (F32_VARIANTS if args.dtype == "float32" else {})
    libs = build_variants(patched((_build.CSRC / "deform_conv3d.cu").read_text()), _build.CSRC, "split_k1", variants)
    dtype, pack = getattr(torch, args.dtype), PACK[args.dtype]
    print(json.dumps({"card": _card(), "dtype": args.dtype, "shape": list(SHAPE)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sums = dict.fromkeys([*variants, "pack"], 0.0)
    for cin in CINS:
        x = torch.randn(SHAPE + (cin,), generator=gen, device="cuda").to(dtype)
        off = (torch.randn(SHAPE + (3 * KTAPS,), generator=gen, device="cuda") * 2.0).to(dtype)
        w = (torch.randn((3, 3, 3, cin, CO), generator=gen, device="cuda") / math.sqrt(27 * cin)).to(dtype)
        bias = torch.randn((CO,), generator=gen, device="cuda").to(dtype)
        xp, wpk = pack(x, w)
        timings = {"pack": min(cuda_ms(lambda: pack(x, w), ITERS) for _ in range(3))}
        for v, lib in libs.items():
            call = variant_call(lib, xp, off, wpk, bias, cin)
            call()
            torch.cuda.synchronize()
            timings[v] = min(cuda_ms(call, ITERS) for _ in range(3))
        for v, ms in timings.items():
            sums[v] += ms
            print(json.dumps({"dtype": args.dtype, "variant": v, "cin": cin, "ms": ms}), flush=True)
    print(json.dumps({"dtype": args.dtype, "sum_ms": sums,
                      "cost_ms": {v: sums["full"] - t for v, t in sums.items() if v not in ("full", "pack")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
