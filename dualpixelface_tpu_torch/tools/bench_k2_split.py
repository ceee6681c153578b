"""Where K2's time goes on the card: the kernel beside builds of it that
leave one part out.

    python3 -m dualpixelface_tpu_torch.tools.bench_k2_split [--csrc DIR] [--dtype float32]

Builds `deform_conv3d_bwd.cu` from the package's `csrc/` (or from DIR, the
`csrc/` of another checkout, such as the parent's unpacked with `git
archive`) five times with nvcc: as it is, and with one part compiled out
each time (the contractions, the corner gathers of x, the gx atomics, or
the whole main kernel, leaving the gw reduce pass and the gx cast). The
variants' outputs are wrong by design; they are timed only. Each runs on
the same seeded inputs (aperture on, Cin 35 and 64) at the route's shapes
(bf16: the train path's [2, 4, 192, 144, Cin]; f32: the trainer's batch
4, [4, 4, 192, 144, Cin]) with CUDA events, the best of three runs of
ITERS launches, and is printed as one JSON line after the card's name and
power limit; a last line sums the two Cin. What a part costs is the full
kernel's time less the time without it.

Takes two designs: the tensor-core kernels, bf16 (`dpf_deform_conv3d_bwd_tc`)
or, with `--dtype float32`, the f32 route's 3xTF32 kernel
(`dpf_deform_conv3d_bwd_3xtf32`; both are patched in the one source), and
the SIMT kernel that served bf16 before them (an older
`dpf_deform_conv3d_bwd` with an `is_bf16` argument). Needs a GPU and nvcc;
builds into `split/` beside the kernels' build directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
from pathlib import Path

import torch

from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
    CO, KTAPS, bwd_plan, pack_deform_bwd, pack_deform_bwd_3xtf32)
from dualpixelface_tpu_torch.tools import build_variants as tools_build_variants
from dualpixelface_tpu_torch.tools import cuda_ms, require_cuda

SHAPE = (2, 4, 192, 144)  # the train path's ANM volume, batch 2 at 768x576
F32_SHAPE = (4, 4, 192, 144)  # the trainer's (every committed run config: f32, batch 4)
CINS = (35, 64)
ITERS = 5
SEED = 1
VARIANTS = {"full": [], "no_contractions": ["-DNO_CONTRACTIONS"], "no_gathers": ["-DNO_GATHERS"],
            "no_atomics": ["-DNO_ATOMICS"], "reduce_cast_only": ["-DNO_MAIN"]}

_GUARDS = ("#ifdef NO_MAIN\n#define NO_MAIN_FLAG 1\n#else\n#define NO_MAIN_FLAG 0\n#endif\n"
           "#ifdef NO_CONTRACTIONS\n#define NO_CONTRACTIONS_FLAG 1\n#else\n#define NO_CONTRACTIONS_FLAG 0\n#endif\n"
           "#ifdef NO_ATOMICS\n#define NO_ATOMICS_FLAG 1\n#else\n#define NO_ATOMICS_FLAG 0\n#endif\n"
           "#ifdef NO_GATHERS\n#define K2_X_LOAD(id) make_uint2(0x3f803f80u ^ (unsigned)((id) & 7), 0x3f803f80u)\n"
           "#define K2_X_LOAD4(id) make_float4(1.0f + (float)((id) & 7), 1.0f, 1.0f, 1.0f)\n"
           "#else\n#define K2_X_LOAD(id) __ldg(reinterpret_cast<const uint2*>(x + (size_t)(id) * ldx + cb + c))\n"
           "#define K2_X_LOAD4(id) __ldg(reinterpret_cast<const float4*>(x + (size_t)(id) * CP + c))\n#endif\n")

# (text, replacement) pairs that put each part under its macro, per design
PATCHES = {
    "tensor_cores": [
        ('#include "tma.cuh"\n', '#include "tma.cuh"\n' + _GUARDS),
        # the tuned form's gcols product (the wide form's, indented deeper, is left as it is)
        ("\n          for (int h = 0; h < 2; ++h) tc::Wgmma<CP>::mma(accg[h], tc::desc(gt + h * 64 * 128 + kk * 32), db);\n",
         "\n#ifndef NO_CONTRACTIONS\n          for (int h = 0; h < 2; ++h) "
         "tc::Wgmma<CP>::mma(accg[h], tc::desc(gt + h * 64 * 128 + kk * 32), db);\n#endif\n"),
        ("      for (int kk = 0; kk < TBM / 16; ++kk)\n        tc::Wgmma<64, 1, 1>::mma(",
         "#ifndef NO_CONTRACTIONS\n      for (int kk = 0; kk < TBM / 16; ++kk)\n        tc::Wgmma<64, 1, 1>::mma("),
        ("tc::desc(gt + kk * 2048));\n", "tc::desc(gt + kk * 2048));\n#endif\n"),
        ("__ldg(reinterpret_cast<const uint2*>(x + (size_t)ids[q] * ldx + cb + c))", "K2_X_LOAD(ids[q])"),
        ("            if (wq != 0.0f && cb + c < C)\n              red_add4(",
         "#ifndef NO_ATOMICS\n            if (wq != 0.0f && cb + c < C)\n              red_add4("),
        ("wq * g01.x, wq * g01.y, wq * g23.x, wq * g23.y);\n", "wq * g01.x, wq * g01.y, wq * g23.x, wq * g23.y);\n#endif\n"),
        ("  rc = CP == 40 ? launch_tc<40, false>", "  rc = NO_MAIN_FLAG ? 0 : CP == 40 ? launch_tc<40, false>"),
        # the f32 route's kernel, in the same source
        # the tuned kernel's (`deform_bwd_3xtf32_kernel`; the wide kernel's texts differ)
        ("\n          tc::mma_3xtf32<CP>(accg, ", "\n          if (!NO_CONTRACTIONS_FLAG) tc::mma_3xtf32<CP>(accg, "),
        ("          tc::mma_3xtf32<CP>(accw, ah[kk], al[kk], cb, ",
         "          if (!NO_CONTRACTIONS_FLAG) tc::mma_3xtf32<CP>(accw, ah[kk], al[kk], cb, "),
        ("__ldg(reinterpret_cast<const float4*>(x + (size_t)ids[q] * CP + c))", "K2_X_LOAD4(ids[q])"),
        ("          if (c < C && wq != 0.0f) red_add4(", "          if (!NO_ATOMICS_FLAG && c < C && wq != 0.0f) red_add4("),
        ("  rc = CP == 40 ? launch_3xtf32<40, false>", "  rc = NO_MAIN_FLAG ? 0 : CP == 40 ? launch_3xtf32<40, false>"),
    ],
    "simt_bf16": [
        ('#include "common.cuh"\n', '#include "common.cuh"\n' + _GUARDS),
        ("for (int n = 0; n < CO; ++n) {",
         "#ifdef NO_CONTRACTIONS\n      for (int n = 0; n < 1; ++n) {\n#else\n      for (int n = 0; n < CO; ++n) {\n#endif"),
        ("for (int r = 0; r < TV; ++r) {",
         "#ifdef NO_CONTRACTIONS\n    for (int r = 0; r < 1; ++r) {\n#else\n    for (int r = 0; r < TV; ++r) {\n#endif"),
        ("const float xv = to_f32(x[(size_t)id * C + c]);",
         "\n#ifdef NO_GATHERS\n            const float xv = (float)((id + c) & 3);\n#else\n"
         "            const float xv = to_f32(x[(size_t)id * C + c]);\n#endif\n"),
        ("if (wq != 0.0f) atomicAdd(&gx32[(size_t)id * C + c], wq * gc);",
         "\n#ifndef NO_ATOMICS\n            if (wq != 0.0f) atomicAdd(&gx32[(size_t)id * C + c], wq * gc);\n#endif\n"),
        ("  deform_bwd_kernel<T><<<", "  if (!NO_MAIN_FLAG) deform_bwd_kernel<T><<<"),
    ],
}


def design(source: str) -> str:
    if "dpf_deform_conv3d_bwd_tc" in source:
        return "tensor_cores"
    if "int is_bf16, void* stream" in source:
        return "simt_bf16"
    raise SystemExit("bench_k2_split: no K2 design it knows in this source")


def patched(source: str) -> tuple[str, str]:
    """The design of a K2 source and the source with each part under its
    macro; raises if a text to patch is not there exactly once."""
    kind = design(source)
    for old, new in PATCHES[kind]:
        if source.count(old) != 1:
            raise SystemExit(f"bench_k2_split: the {kind} source no longer holds {old!r} once")
        source = source.replace(old, new)
    return kind, source


def build_variants(csrc: Path) -> tuple[str, dict[str, ctypes.CDLL]]:
    """Patch and build the variants of csrc/deform_conv3d_bwd.cu, all at
    once; returns the design and each variant's loaded library."""
    kind, source = patched((csrc / "deform_conv3d_bwd.cu").read_text())
    return kind, tools_build_variants(source, csrc, "split", VARIANTS)


def variant_call(kind: str, lib: ctypes.CDLL, x, off, w, g):
    """A no-argument launch of the variant's C entry point on these inputs,
    with the scratch and outputs its wrapper would allocate."""
    b, d, h, wd, c = x.shape
    dev, f32 = x.device, torch.float32
    goff, gw, gx = torch.empty_like(off), torch.empty_like(w), torch.empty_like(x)
    stream = _build.current_stream(dev)
    if kind == "tensor_cores":
        _, cp, nsplit = bwd_plan(x.shape, x.dtype, torch.cuda.get_device_properties(dev).multi_processor_count)
        f32_route = x.dtype == f32
        xp, wpk = (pack_deform_bwd_3xtf32 if f32_route else pack_deform_bwd)(x, w)
        gx32 = torch.empty((b, d, h, wd, cp), dtype=f32, device=dev)
        if f32_route and c == cp:
            gx = gx32  # the kernel's own layout: no cast pass
        fn = lib.dpf_deform_conv3d_bwd_3xtf32 if f32_route else lib.dpf_deform_conv3d_bwd_tc
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        args = (xp.data_ptr(), off.data_ptr(), wpk.data_ptr(), g.data_ptr(), None, gx.data_ptr(), goff.data_ptr(),
                None, gw.data_ptr(), b, d, h, wd, c, cp, CO, nsplit, 1, stream)
        keep = (xp, wpk)
    else:  # the SIMT design's split count: a share of 32-voxel tiles per block, at most 32
        nsplit = max(1, min(32, -(-math.prod(x.shape[:4]) // 4096)))
        gx32 = torch.empty(x.shape, dtype=f32, device=dev)
        fn = lib.dpf_deform_conv3d_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        args = (x.data_ptr(), off.data_ptr(), w.data_ptr(), g.data_ptr(), None, gx.data_ptr(), goff.data_ptr(),
                None, gw.data_ptr(), b, d, h, wd, c, CO, nsplit, 1, 1, stream)
        keep = ()
    gwp = torch.empty((nsplit, KTAPS * c, CO), dtype=f32, device=dev)
    args = list(args)
    args[4], args[7] = gx32.data_ptr(), gwp.data_ptr()
    fn.restype = ctypes.c_int

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"bench_k2_split: launch failed with cudaError {rc}")

    call.keep = (keep, gx32, gwp, goff, gw, gx)
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC, help="the csrc/ directory to build K2 from")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the route to split: bf16, or the f32 route at the trainer's batch 4")
    args = ap.parse_args()
    require_cuda("bench_k2_split")
    from dualpixelface_tpu_torch.profile_serving import _card

    kind, libs = build_variants(args.csrc.resolve())
    dtype = getattr(torch, args.dtype)
    if dtype == torch.float32 and kind != "tensor_cores":
        raise SystemExit("bench_k2_split: the SIMT design has no f32 route to split")
    shape = F32_SHAPE if dtype == torch.float32 else SHAPE
    print(json.dumps({"card": _card(), "csrc": str(args.csrc), "design": kind, "dtype": args.dtype,
                      "shape": shape}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sums = dict.fromkeys(VARIANTS, 0.0)
    for cin in CINS:
        x = torch.randn(shape + (cin,), generator=gen, device="cuda").to(dtype)
        off = (torch.randn(shape + (3 * KTAPS,), generator=gen, device="cuda") * 2.0).to(dtype)
        w = (torch.randn((3, 3, 3, cin, CO), generator=gen, device="cuda") / math.sqrt(27 * cin)).to(dtype)
        g = torch.randn(shape + (CO,), generator=gen, device="cuda").to(dtype)
        for v, lib in libs.items():
            call = variant_call(kind, lib, x, off, w, g)
            call()
            torch.cuda.synchronize()
            ms = min(cuda_ms(call, ITERS) for _ in range(3))
            sums[v] += ms
            print(json.dumps({"design": kind, "dtype": args.dtype, "variant": v, "cin": cin, "ms": ms}), flush=True)
            del call
            torch.cuda.empty_cache()
    print(json.dumps({"design": kind, "dtype": args.dtype, "sum_ms": sums,
                      "cost_ms": {v: sums["full"] - t for v, t in sums.items() if v != "full"}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
