"""Where K1's time goes on the card: its tensor-core kernel beside builds
of it that leave one part out, and the wrapper's packing alone.

    python3 -m dualpixelface_tpu_torch.tools.bench_k1_split

Builds `deform_conv3d.cu` from the package's `csrc/` four times with nvcc:
as it is; without the contraction (no `wgmma`); with every corner load of
x reading the corner-0 row of its voxel (the same addresses a lane just
read, so the loads hit L1: what is left of the gather without its traffic
beyond L1); and with no loads of x at all (a value made from the index).
The variants' outputs are wrong by design; they are timed only. Each runs
the bf16 route on the same seeded inputs at the serving path's shapes
([4, 4, 192, 144, Cin], Cin 35 and 64, aperture on) with CUDA events, the
best of three runs of ITERS launches of the C entry point on operands
packed once, and is printed as one JSON line after the card's name and
power limit, as is `pack_deform_fwd` alone; a last line sums the two Cin.
What a part costs is the full kernel's time less the time without it.
Needs a GPU and nvcc; builds into `split_k1/` beside the kernels' build
directory.
"""
from __future__ import annotations

import ctypes
import json
import math

import torch

from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.kernels.deform_fused import CO, KTAPS, pack_deform_fwd
from dualpixelface_tpu_torch.tools import build_variants, cuda_ms, require_cuda

SHAPE = (4, 4, 192, 144)  # the serving path's ANM volume, batch 4 at 768x576
CINS = (35, 64)
ITERS = 10
SEED = 0
VARIANTS = {"full": [], "no_contraction": ["-DNO_CONTRACTION"], "l1_gathers": ["-DL1_GATHERS"],
            "no_gathers": ["-DNO_GATHERS"]}

_GUARDS = ("#if defined(NO_GATHERS)\n"
           "#define K1_X_LOAD(q) make_uint4(0x3f803f80u ^ (unsigned)(id[q] & 7), 0x3f803f80u, 0x3f803f80u, 0x3f803f80u)\n"
           "#elif defined(L1_GATHERS)\n"
           "#define K1_X_LOAD(q) __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[0] * CP + c))\n"
           "#else\n#define K1_X_LOAD(q) __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * CP + c))\n#endif\n")

# (text, replacement) pairs that put each part under its macro
PATCHES = [
    ('#include "tma.cuh"\n', '#include "tma.cuh"\n' + _GUARDS),
    ("xr[q] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * CP + c));", "xr[q] = K1_X_LOAD(q);"),
    ("#pragma unroll\n    for (int kk = 0; kk < KP / 16; ++kk) tc::Wgmma<64, 0, 1>::mma(",
     "#ifndef NO_CONTRACTION\n#pragma unroll\n    for (int kk = 0; kk < KP / 16; ++kk) tc::Wgmma<64, 0, 1>::mma("),
    ("tc::desc(sb + kk * 2048));\n", "tc::desc(sb + kk * 2048));\n#endif\n"),
]


def patched(source: str) -> str:
    """K1's source with each part under its macro; raises if a text to
    patch is not there exactly once."""
    for old, new in PATCHES:
        if source.count(old) != 1:
            raise SystemExit(f"bench_k1_split: the source no longer holds {old!r} once")
        source = source.replace(old, new)
    return source


def variant_call(lib: ctypes.CDLL, xp, off, wpk, bias, c: int):
    """A no-argument launch of the variant's C entry point on operands
    already packed, into an output it allocates once."""
    b, d, h, w, cp = xp.shape
    out = torch.empty((b, d, h, w, CO), dtype=xp.dtype, device=xp.device)
    fn = lib.dpf_deform_conv3d_tc
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
    require_cuda("bench_k1_split")
    from dualpixelface_tpu_torch.profile_serving import _card

    libs = build_variants(patched((_build.CSRC / "deform_conv3d.cu").read_text()), _build.CSRC, "split_k1", VARIANTS)
    print(json.dumps({"card": _card(), "shape": list(SHAPE)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sums = dict.fromkeys([*VARIANTS, "pack"], 0.0)
    for cin in CINS:
        bf16 = torch.bfloat16
        x = torch.randn(SHAPE + (cin,), generator=gen, device="cuda").to(bf16)
        off = (torch.randn(SHAPE + (3 * KTAPS,), generator=gen, device="cuda") * 2.0).to(bf16)
        w = (torch.randn((3, 3, 3, cin, CO), generator=gen, device="cuda") / math.sqrt(27 * cin)).to(bf16)
        bias = torch.randn((CO,), generator=gen, device="cuda").to(bf16)
        xp, wpk = pack_deform_fwd(x, w)
        timings = {"pack": min(cuda_ms(lambda: pack_deform_fwd(x, w), ITERS) for _ in range(3))}
        for v, lib in libs.items():
            call = variant_call(lib, xp, off, wpk, bias, cin)
            call()
            torch.cuda.synchronize()
            timings[v] = min(cuda_ms(call, ITERS) for _ in range(3))
        for v, ms in timings.items():
            sums[v] += ms
            print(json.dumps({"variant": v, "cin": cin, "ms": ms}), flush=True)
    print(json.dumps({"sum_ms": sums,
                      "cost_ms": {v: sums["full"] - t for v, t in sums.items() if v not in ("full", "pack")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
