#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the nine CUDA kernels from `dualpixelface_tpu_torch/csrc/`
     (one nvcc per source, all at once), print the build seconds and each
     entry function's registers, shared memory and spill bytes from the
     build log; a tensor-core kernel (the bf16 routes of K1, of K5 and T1,
     of K2 and of T4) or an instantiation of K3 or K4 (each dtype, D = 1..16)
     that spills, or one missing from the log, fails;
  3. check each forward kernel (K1, K5) against its plain PyTorch
     version on the same seeded CUDA tensors at the serving path's shapes,
     in bf16 and f32 (TF32 off); each K1 check names its route, the
     tensor cores for bf16 and the SIMT kernel for f32;
  3b. the same for the backward kernels at the train path's shapes: K2 (all
     four gradients, both apertures, a quarter of the offsets whole numbers
     and some on the window bound; each check names its route, the
     tensor cores for bf16 and the SIMT kernel for f32);
  3c. K1 (Cin 35 and 64, both apertures), K5 (Cin 35 and 64), T1 (Co 32
     and 64, without and with the folded BatchNorm and ReLU) and K2 (Cin 35
     and 64, both apertures) at small ragged shapes (`EDGE_SHAPES`: M no
     multiple of a tile, H or W below 3, D = 1), bf16 and f32;
  3d. K3 at the serving batch and K4 at the train batch, at the paths'
     coarse shape for D = 8, 5 and 16 and at (50, 36) for every D = 1..16
     (each instantiation), then logits of scale 30 with a cell of planes
     near -200 and one whose bins all underflow below the max over its
     planes, f32 and bf16; K4 twice on the same inputs, bit for bit;
  4. time each forward kernel, its plain version and, for K5, cuDNN's
     conv3d (which the port never calls) in NCDHW and in channels_last_3d
     (the kernel's own NDHWC), the faster of the two as its `library_ms`,
     with CUDA events; one `K1_run` and one `K5_run` line per Cin (K1's
     time includes its operands' packing);
  4b. the same for K2 at the train path's shapes;
  4c. K3 (serving shape) and K4 (train shape) in bf16, with CUDA events and
     on the device alone (`tools.device_ms`, the union of the device
     intervals: the host's dispatch left out), beside their plain versions;
  5. serve 3 request batches of 4 dual-pixel pairs at 768x576 in bf16
     through `Predictor` (seeded weights, non-zero offset heads): shapes,
     finiteness, launch counts (K1 +2, K5 +2, K3 +1 per forward), and a
     smoke reading of pairs/s (the serving rate proper, over many batches,
     is `python3 -m dualpixelface_tpu_torch.profile_serving`'s);
  6. the same weights at 192x192, batch 1, f32: the card's forward (kernels)
     against the CPU forward (plain versions);
  7. train 3 steps in the train cell (the run keys `profile_train.
     TRAIN_CELL`: batch 2 under the bf16 policy) at 768x576 through
     `make_train_step` (the same seeded weights, Adam): finite losses,
     every weight moved and still the optimizer's f32 master, launch
     counts per step (K1 2, K5 2, K3 3, K2 2, K4 3), the peak memory, and a
     smoke reading of pairs/s through `profile_serving.timed` (the rate
     proper is profile_train's);
  8. one f32 train step of batch 2 at 32x32 from the committed plateau
     checkpoint on the card against the same step on the CPU, at a point
     where both took the same side of every kink: losses and each
     parameter's gradient;
  9. the tools' kernels (`tools_phase`): T2-T4 at the eight runs of
     `python3 -m dualpixelface_tpu_torch.tools.bench_vpu_prims` (G = 4096)
     and T1 at the four stride-1 hourglass sites of
     `python3 -m dualpixelface_tpu_torch.tools.bench_dslice_fold` (768x576,
     batch 4), each checked against its plain version and then driven
     through its tool's measurement, timed beside its bound; before them,
     T4 at ragged m (1, 33, 130) and k (8, 72, 2248), f32 and bf16.
Then one line sets K5's bf16 time beside cuDNN's faster layout and T1's
beside the ConvBN3D + ReLU chain, summed over their shapes (a reading,
not a check).
The line before the last is the `kernels` JSON with nine rows (launches:
K1-K5 the train path's run of phase 7, `launches_serving` phase 5's; T1-T4
the tools' measurements in phase 9, whose T rows sum the runs' times and
bounds; K3 and K4 also carry `device_ms`, phase 4c's time on the device
alone); the last line is {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Serving path shapes (stereodpnet_plus at 768x576, batch 4): the ANM volume
# is [B, K=4, H/4, W/4, C] with C = 35 into deform_conv1, 64 into deform_conv2.
B, H, W = 4, 768, 576
ANM_SHAPE = (B, 4, H // 4, W // 4)
CINS = (35, 64)
COUT = 64
REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # of max(1, max|plain|)

# Train path shapes (batch 2 at 768x576): the ANM volume [2, 4, 192, 144, C].
TB = 2
TRAIN_ANM_SHAPE = (TB, 4, H // 4, W // 4)
# backward tolerances, of max(1, max|plain|). gx and goff as the forward's
# (f32 sums of <= 27 x 8 terms; bf16: the plain version rounds gcols and the
# results once, the kernel likewise, in another order: goff sums 64 channels
# of rounded gcols, hence 2e-2). gw sums 221,184 voxel products per entry in
# f32: the two orders differed by 2.2e-6 of the largest entry (f32, on an
# H100 80GB HBM3 at 700 W), held to 2e-5; in bf16 the output's own rounding
# decides.
BWD_TOL = {"float32": {"gx": 1e-4, "goff": 1e-4, "gw": 2e-5, "gb": 1e-4},
           "bfloat16": {"gx": 1e-2, "goff": 2e-2, "gw": 2e-2, "gb": 1e-2}}

# The least f32 work (FMA = 2 operations) per (voxel, tap, input channel)
# outside the contractions, which run on the tensor cores; the per-(voxel,
# tap) positions and corner weights are shared by the channels (35 or 64)
# and left out. K1: the trilinear sample from its 8 corners with the voxel
# tap's 8 corner weights, 1 multiply + 7 FMA = 15. K2: the sample and its 3
# position derivatives, factorised (x: 4 corner-pair differences + 4 FMA =
# 12; y: 2 + 2 FMA = 6; z: 1 + 1 FMA = 3, whose difference is d/dz; d/dy:
# the 2 y differences lerped in z, 3; d/dx: the 4 x differences against the
# 4 (y, z) weights, 1 multiply + 3 FMA = 7): 31; gx, each corner's share
# gcols x weight added into its sum, 8 FMA = 16; goff, gcols x each
# derivative summed over the channels, 3 FMA = 6: 53 in all.
K1_F32_OPS = 15
K2_F32_OPS = 53

# phase 3c: [B, D, H, W] of K1's, K5's, T1's and K2's ragged checks: M = 10, 378, 4, 15
# (no multiple of a 128-voxel tile), H = 2 and 1, W = 2 and 1, D = 1
EDGE_SHAPES = ((1, 1, 2, 5), (2, 3, 7, 9), (1, 2, 1, 2), (3, 5, 1, 1))

TPU_SITES = {
    "K1": "dualpixelface_tpu/ops/kernels/deform_fused.py:598",
    "K2": "dualpixelface_tpu/ops/kernels/deform_fused.py:985",
    "K3": "dualpixelface_tpu/ops/kernels/fused_softargmin.py:238",
    "K4": "dualpixelface_tpu/ops/kernels/fused_softargmin.py:198",
    "K5": "dualpixelface_tpu/ops/kernels/conv3d_dslice.py:207",
    "T1": "tools/attic/conv3d_dslice_v2.py:139",
    "T2": "tools/bench_vpu_prims.py:39",
    "T3": "tools/bench_vpu_prims.py:70",
    "T4": "tools/bench_vpu_prims.py:94",
}
SOURCES = {"K1": "deform_conv3d.cu", "K2": "deform_conv3d_bwd.cu", "K3": "fused_softargmin.cu",
           "K4": "fused_softargmin_bwd.cu", "K5": "conv3d_dslice.cu", "T1": "conv3d_dslice_v2.cu",
           "T2": "prims_gather.cu", "T3": "prims_transpose.cu", "T4": "prims_dot.cu"}
NAMES = {"K1": "deform_conv3d_fused", "K2": "deform_conv3d_bwd", "K3": "fused_softargmin",
         "K4": "fused_softargmin_bwd", "K5": "conv3d_dslice", "T1": "conv3d_dslice_v2", "T2": "lane_gather_sum",
         "T3": "transpose_sum", "T4": "batched_dot"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str) -> list[dict]:
    """Per entry function of an `nvcc -Xptxas=-v` log: its mangled name,
    registers, static shared memory and spill bytes."""
    funcs = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            funcs.append({"function": m.group(1)})
        elif funcs and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            funcs[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif funcs and (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)):
            funcs[-1].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return funcs


def print_build_report(report: dict) -> None:
    """Phase 2's report: each entry function's registers, shared memory
    (static, and for the tensor-core kernels and K4 the dynamic shared
    memory their C entry points report) and spill bytes; fails if a
    tensor-core kernel or an instantiation of K3 or K4 spills or is missing
    from the log."""
    import ctypes

    from dualpixelface_tpu_torch.ops.kernels import _build

    def smem(lib, symbol, *args):
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        return fn(*args)

    # (library, kernel, template argument) of each tensor-core instantiation
    dynamic = {("conv3d_dslice", "conv3d_tc_kernel", 88): smem("conv3d_dslice", "dpf_conv3d_k3_smem_bytes")}
    dynamic.update({("conv3d_dslice_v2", "conv3d_tc_kernel", co):
                    smem("conv3d_dslice_v2", "dpf_conv3d_k3_affine_smem_bytes", co) for co in (32, 64)})
    dynamic.update({("prims_dot", "dot_bf16_kernel", mt): smem("prims_dot", "dpf_batched_dot_smem_bytes", mt)
                    for mt in (1, 2)})
    dynamic.update({("deform_conv3d_bwd", "deform_bwd_tc_kernel", cp):
                    smem("deform_conv3d_bwd", "dpf_deform_conv3d_bwd_tc_smem_bytes") for cp in (40, 64)})
    dynamic.update({("deform_conv3d", "deform_fwd_tc_kernel", cp):
                    smem("deform_conv3d", "dpf_deform_conv3d_tc_smem_bytes", cp) for cp in (40, 64)})
    # K3's and K4's instantiations: each dtype and D = 1..16; none may spill
    fsam = {(k, t, d) for k in ("fwd", "bwd") for t in ("f", "13__nv_bfloat16") for d in range(1, 17)}
    seen = set()
    for name, r in report.items():
        for f in ptxas_report(r["log"]):
            line = (f"ptxas {name}: {f['function']}: {f.get('registers')} registers, {f.get('static_smem')} bytes "
                    f"static smem, spill stores {f.get('spill_stores')} / loads {f.get('spill_loads')} bytes")
            if m := re.search(r"fsam_(fwd|bwd)_kernelI(f|13__nv_bfloat16)Li(\d+)E", f["function"]):
                key = (m.group(1), m.group(2), int(m.group(3)))
                fsam.discard(key)
                if key[0] == "bwd":
                    line += f", dynamic smem {smem('fused_softargmin_bwd', 'dpf_fused_softargmin_bwd_smem_bytes', key[2])} bytes"
                if f.get("spill_stores") != 0 or f.get("spill_loads") != 0:
                    fail(f"the K3/K4 kernel {f['function']} spills: {f}")
            if m := re.search(r"(conv3d_tc_kernel|dot_bf16_kernel|deform_bwd_tc_kernel|deform_fwd_tc_kernel)ILi(\d+)E", f["function"]):
                key = (name, m.group(1), int(m.group(2)))
                seen.add(key)
                line += f", dynamic smem {dynamic[key]} bytes ({key[1]}<{key[2]}>)"
                if f.get("spill_stores") != 0 or f.get("spill_loads") != 0:
                    fail(f"the tensor-core kernel {f['function']} spills: {f}")
            print(line, flush=True)
    if seen != set(dynamic):
        fail(f"the build log reports tensor-core kernels {sorted(seen)}, not {sorted(dynamic)}")
    if fsam:
        fail(f"the build log lacks K3/K4 instantiations {sorted(fsam)}")


def compare(name: str, got, ref, dtype_name: str, rel_tol: float | None = None) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    if got.dtype != ref.dtype:
        fail(f"{name}: dtype {got.dtype} != plain {ref.dtype}")
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = (REL_TOL[dtype_name] if rel_tol is None else rel_tol) * max(1.0, float(ref.abs().max()))
    print(f"check {name} {dtype_name}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        fail(f"{name} {dtype_name}: kernel disagrees with its plain version: {err} > {tol}")
    return err


def kernel_inputs(torch, gen, cin, dtype, shape=ANM_SHAPE, on_bound=False):
    dev = "cuda"
    x = torch.randn(shape + (cin,), generator=gen, device=dev).to(dtype)
    off = torch.randn(shape + (81,), generator=gen, device=dev) * 2.0
    # a quarter of the offsets are whole numbers: positions exactly on the grid
    whole = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(whole, torch.round(off), off)
    if on_bound:
        # a tenth of the H/W offsets exactly on the window bound, where the
        # aperture clamp passes half the gradient
        k = torch.arange(81, device=dev)
        kh = ((k // 3 // 3) % 3 - 1).float()
        kw = ((k // 3) % 3 - 1).float()
        lo = torch.where(k % 3 == 1, -3.0 - kh, -3.0 - kw)
        hi = torch.where(k % 3 == 1, 4.0 - 1.0 / 1024 - kh, 4.0 - 1.0 / 1024 - kw)
        pick = (torch.rand(off.shape, generator=gen, device=dev) < 0.1) & (k % 3 != 0)
        high = torch.rand(off.shape, generator=gen, device=dev) < 0.5
        off = torch.where(pick, torch.where(high, hi, lo), off)
    off = off.to(dtype)
    w = (torch.randn((3, 3, 3, cin, COUT), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    bias = torch.randn((COUT,), generator=gen, device=dev).to(dtype)
    w_off = (torch.randn((3, 3, 3, cin, 81), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    b_off = torch.randn((81,), generator=gen, device=dev).to(dtype)
    return x, off, w, bias, w_off, b_off


def check_and_time_kernels(torch):
    from dualpixelface_tpu_torch.tools import cuda_ms, cudnn_conv3d_calls
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice, conv3d_dslice_plain
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import deform_conv3d_fused, deform_conv3d_plain, fwd_route

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    err = {"K1": 0.0, "K5": 0.0}
    timing = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0, "bytes": 0.0, "flops_f32": 0.0}
              for k in err}

    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in CINS:
            x, off, w, bias, w_off, b_off = kernel_inputs(torch, gen, cin, dtype)
            for aperture in (True, False):
                e = compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] Cin={cin} aperture={aperture}",
                            deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                            deform_conv3d_plain(x, off, w, bias, aperture=aperture), dname)
                if dtype == bf16 and aperture:
                    err["K1"] = max(err["K1"], e)
            e = compare(f"K5 conv3d_dslice Cin={cin}", conv3d_dslice(x, w_off, b_off),
                        conv3d_dslice_plain(x, w_off, b_off), dname)
            if dtype == bf16:
                err["K5"] = max(err["K5"], e)
            if dtype != bf16:
                continue
            # timing at the serving dtype; the two Cin shapes of one forward add up
            k1 = timing["K1"]
            m = math.prod(ANM_SHAPE)
            run = {"cin": cin, "route": fwd_route(dtype),
                   "ms": cuda_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5),
                   "plain_ms": cuda_ms(lambda: deform_conv3d_plain(x, off, w, bias, aperture=True), 2),
                   "flops": 2.0 * m * 27 * cin * COUT}
            run["tflops"] = run["flops"] / run["ms"] / 1e9
            print(json.dumps({"K1_run": run}), flush=True)
            k1.setdefault("runs", []).append(run)
            k1["ms"] += run["ms"]
            k1["plain_ms"] += run["plain_ms"]
            k1["flops"] += run["flops"]
            k1["flops_f32"] += K1_F32_OPS * m * 27 * cin
            k1["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w, bias)) + m * COUT * 2
            k5 = timing["K5"]
            run = {"cin": cin, "ms": cuda_ms(lambda: conv3d_dslice(x, w_off, b_off), 5),
                   "plain_ms": cuda_ms(lambda: conv3d_dslice_plain(x, w_off, b_off), 2),
                   "flops": 2.0 * m * 27 * cin * 81}
            for layout, call in cudnn_conv3d_calls(x, w_off, b_off).items():
                run[f"cudnn_{layout}_ms"] = cuda_ms(call, 5)
            run["cudnn_layout"] = min(("ncdhw", "channels_last_3d"), key=lambda k: run[f"cudnn_{k}_ms"])
            run["cudnn_ms"] = run[f"cudnn_{run['cudnn_layout']}_ms"]
            run["tflops"] = run["flops"] / run["ms"] / 1e9
            print(json.dumps({"K5_run": run}), flush=True)
            k5.setdefault("runs", []).append(run)
            k5["ms"] += run["ms"]
            k5["plain_ms"] += run["plain_ms"]
            k5["library_ms"] = (k5["library_ms"] or 0.0) + run["cudnn_ms"]
            k5["flops"] += run["flops"]
            k5["bytes"] += sum(t.numel() * t.element_size() for t in (x, w_off, b_off)) + m * 81 * 2

    return err, timing


def check_and_time_backward_kernels(torch, err, timing):
    """Phases 3b and 4b: K2 and K4 against autograd through their plain
    versions at the train path's shapes, in f32 and bf16; their times at
    bf16, the train dtype. The plain K2 at this shape holds ~30 GB of
    autograd state, so each comparison frees it before the next."""
    from dualpixelface_tpu_torch.tools import cuda_ms
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    err["K2"] = 0.0
    timing["K2"] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0, "bytes": 0.0, "flops_f32": 0.0}
    m = math.prod(TRAIN_ANM_SHAPE)
    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in CINS:
            x, off, w, bias, _, _ = kernel_inputs(torch, gen, cin, dtype, TRAIN_ANM_SHAPE, on_bound=True)
            g = torch.randn(TRAIN_ANM_SHAPE + (COUT,), generator=gen, device="cuda").to(dtype)
            for aperture in (True, False):
                got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
                ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=aperture)
                for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                    e = compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} Cin={cin} aperture={aperture}",
                                a, r, dname, BWD_TOL[dname][gname])
                    if dtype == bf16 and aperture:
                        err["K2"] = max(err["K2"], e)
                del got, ref
                torch.cuda.empty_cache()
            if dtype != bf16:
                continue
            k2 = timing["K2"]
            k2["ms"] += cuda_ms(lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True), 3)
            k2["plain_ms"] += cuda_ms(lambda: deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=True), 1)
            torch.cuda.empty_cache()
            # two contractions (gcols = g W^T, gw = cols^T g), twice K1's,
            # and the gather work (K2_F32_OPS per voxel, tap and channel)
            k2["flops"] += 2 * 2.0 * m * 27 * cin * COUT
            k2["flops_f32"] += K2_F32_OPS * m * 27 * cin
            # x, offset, weight and g read; gx, goff and gw written
            k2["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w)) * 2 + g.numel() * g.element_size()


# K3 and K4 (phase 3d): the coarse plane counts held at the paths' shape
# (the configs' 8, and 5 and 16; at (50, 36) every D the kernels are
# instantiated for), and the wide-logit cases: logits of scale 30; one
# coarse cell whose planes are all near -200, past exp's f32 range
# unshifted (near -1e4 the plain version's own f32 rounding strays further
# from the exact value than REL_TOL: tests/test_torch_softargmin_pack.py);
# one whose plane 3 is 0 and the others -3000, so every bin of the pixels
# around it lies more than f32's range below the max over the planes (both
# kernels shift by the largest bin)
SOFTARGMIN_PLANES = (8, 5, 16)


def softargmin_cost(torch, gen, b, d, hw, dtype, wide=False):
    cost = torch.randn((b, d) + hw, generator=gen, device="cuda") * (30.0 if wide else 3.0)
    if wide:
        cost[:, :, 1, 2] = -200.0 + torch.randn((b, d), generator=gen, device="cuda")
        cost[:, :, 5, 5] = -3000.0
        cost[:, 3, 5, 5] = 0.0
    return cost.to(dtype)


def check_and_time_softargmin(torch, err, timing):
    """Phases 3d and 4c: K3 at the serving batch (4) and K4 at the train
    batch (2), at the path's coarse shape (192 x 144) for D in
    SOFTARGMIN_PLANES and at (50, 36) (4h % 32 != 0) for D = 1..16, in f32
    and bf16, then the wide-logit cases at (50, 36), D = 8, against their
    plain versions
    within REL_TOL; K4 twice on the same inputs, which must agree bit for
    bit. Then each kernel's time at its path's shape in bf16: event-timed
    (`cuda_ms`, the host's dispatch included) and on the device alone
    (`device_ms`), beside its plain version and its bound (bytes, f32
    operations and exps, `tools.bench_softargmin.work`)."""
    from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import (
        fused_softargmin, fused_softargmin_bwd, fused_softargmin_bwd_plain, fused_softargmin_plain)
    from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
    from dualpixelface_tpu_torch.tools import bench_softargmin, cuda_ms, device_ms

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(d, (H // 4, W // 4), False) for d in SOFTARGMIN_PLANES]
    cases += [(d, (50, 36), False) for d in range(1, 17)]
    cases.append((8, (50, 36), True))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for d, hw, wide in cases:
            disp = regression_disparities(-4, 12, d, 4)
            label = f"D={d} h,w={hw}" + (" wide logits" if wide else "")
            cost = softargmin_cost(torch, gen, B, d, hw, dtype, wide)
            e = compare(f"K3 fused_softargmin B={B} {label}", fused_softargmin(cost, disp, 4),
                        fused_softargmin_plain(cost, disp, 4), dname)
            if dtype == torch.bfloat16 and (d, hw, wide) == cases[0]:
                err["K3"] = e
            cost = softargmin_cost(torch, gen, TB, d, hw, dtype, wide)
            g = torch.randn((TB, 4 * hw[0], 4 * hw[1]), generator=gen, device="cuda").to(dtype)
            got = fused_softargmin_bwd(cost, g, disp, 4)
            e = compare(f"K4 fused_softargmin_bwd B={TB} {label}", got,
                        fused_softargmin_bwd_plain(cost, g, disp, 4), dname)
            if dtype == torch.bfloat16 and (d, hw, wide) == cases[0]:
                err["K4"] = e
            if not torch.equal(got, fused_softargmin_bwd(cost, g, disp, 4)):
                fail(f"K4 {label} {dname}: two calls on the same inputs differ")
        print(f"check K4 {dname}: two calls on the same inputs agree bit for bit in every case", flush=True)

    disp = regression_disparities(-4, 12, 8, 4)
    cost = softargmin_cost(torch, gen, B, 8, (H // 4, W // 4), torch.bfloat16)
    tcost = softargmin_cost(torch, gen, TB, 8, (H // 4, W // 4), torch.bfloat16)
    g = torch.randn((TB, H, W), generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"K3": (lambda: fused_softargmin(cost, disp, 4), lambda: fused_softargmin_plain(cost, disp, 4),
                    tuple(cost.shape)),
             "K4": (lambda: fused_softargmin_bwd(tcost, g, disp, 4),
                    lambda: fused_softargmin_bwd_plain(tcost, g, disp, 4), tuple(tcost.shape))}
    for k, (fn, plain, shape) in calls.items():
        timing[k] = {"ms": cuda_ms(fn, 20), "device_ms": device_ms(fn, 20), "plain_ms": cuda_ms(plain, 3),
                     "library_ms": None, "flops": 0.0, **bench_softargmin.work(k, shape)}
        print(json.dumps({f"{k}_run": {"shape": list(shape), **timing[k]}}), flush=True)


def check_edge_shapes(torch):
    """Phase 3c: K1, K5, T1 and K2 at the ragged `EDGE_SHAPES`, Cin 35 and
    64, bf16 and f32: K1 (both apertures, each route) and K5 within
    `REL_TOL`, T1 (Co 32 and 64, without and with the folded BatchNorm and
    ReLU) within `bench_dslice_fold.excess_error`'s allowance, K2 (both
    apertures, each route) within `BWD_TOL`."""
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice, conv3d_dslice_plain
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import COS
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
        bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain, deform_conv3d_fused, deform_conv3d_plain, fwd_route)
    from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, dname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for shape in EDGE_SHAPES:
            for cin in CINS:
                x, _, _, _, w_off, b_off = kernel_inputs(torch, gen, cin, dtype, shape)
                compare(f"K5 conv3d_dslice {shape + (cin,)}", conv3d_dslice(x, w_off, b_off),
                        conv3d_dslice_plain(x, w_off, b_off), dname)
                for co in COS:
                    for r in fold.check(fold.site_inputs(shape + (cin,), co, gen, dtype)):
                        print(f"check T1 conv3d_dslice_v2 {shape + (cin,)} -> {co} {dname} ab={r['ab']} "
                              f"relu={r['relu']}: max_abs_err {r['max_abs_err']:.3e}, worst error / allowance "
                              f"{r['worst_ratio']:.3f}", flush=True)
                        if not r["worst_ratio"] <= 1.0:
                            fail(f"T1 {shape + (cin,)} -> {co} {dname}: kernel disagrees with its plain version")
                x, off, w, bias, _, _ = kernel_inputs(torch, gen, cin, dtype, shape, on_bound=True)
                for aperture in (True, False):
                    compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] {shape + (cin,)} aperture={aperture}",
                            deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                            deform_conv3d_plain(x, off, w, bias, aperture=aperture), dname)
                g = torch.randn(shape + (COUT,), generator=gen, device="cuda").to(dtype)
                for aperture in (True, False):
                    got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
                    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=aperture)
                    for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                        compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} {shape + (cin,)} "
                                f"aperture={aperture}", a, r, dname, BWD_TOL[dname][gname])


def tools_phase(torch):
    """Phase 9: the tools' kernels T1-T4, each checked against its plain
    version at the tools' full sizes and then driven through the tool's own
    measurement (`tools.bench_vpu_prims.measure`, `tools.bench_dslice_fold.
    measure`) with the launch counts set to 0 just before and read just
    after: those counts are the T rows' `launches`.

    T2 and T3 must agree bit for bit (the same adds in the same order and
    dtype); T4 within 1e-4 of max(1, max|plain|) (f32 sums of up to 2248
    exact products in another order), at the tool's runs and, first, at
    ragged m and k with G = 64; T1 at the four stride-1 hourglass sites in
    f32 and bf16, without and with the folded BatchNorm and ReLU, within
    1e-4 of max(1, max|plain|) for the sums' order plus, in bf16, one ulp of
    the output (both round one f32 value once). Each tool's inputs are
    allocated once per shape and freed before the next."""
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, prims, reset_launch_counts
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import conv3d_dslice_v2_plain
    from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold
    from dualpixelface_tpu_torch.tools import bench_vpu_prims as vpu
    from dualpixelface_tpu_torch.tools import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0, "bound_ops_ms": 0.0,
                "err": 0.0, "launches": 0, "runs": []} for k in ("T1", "T2", "T3", "T4")}

    def add(row, m, plain_ms, launches):
        row["ms"] += m["ms"]
        row["plain_ms"] += plain_ms
        row["bound_ms"] += m["bound_ms"]
        row["bound_ops_ms"] += m["bound_ms"] if m["bound_by"] == "operations" else 0.0
        row["launches"] += launches
        if m["library_ms"] is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + m["library_ms"]
        row["runs"].append(m)

    # T4 at ragged widths first (k * element size stays a multiple of 16
    # bytes, the kernel's granule); these launches precede the counted runs
    for dtype in (torch.float32, torch.bfloat16):
        for m, k in ((m, k) for m in (1, 33, 130) for k in (8, 72, 2248)):
            a = torch.randn((64, m, k), generator=gen, device="cuda").to(dtype)
            b = torch.randn((64, k, prims.DOT_N), generator=gen, device="cuda").to(dtype)
            rows["T4"]["err"] = max(rows["T4"]["err"], compare(
                f"T4 batched_dot [64, {m}, {k}] x [64, {k}, {prims.DOT_N}]", prims.batched_dot(a, b),
                prims.batched_dot_plain(a, b), str(dtype).removeprefix("torch."), 1e-4))

    for run in vpu.RUNS:
        inputs = run.inputs(gen)
        dname = str(run.dtype).removeprefix("torch.")
        e = compare(f"{run.kernel_id} {run.label}", run.kernel(*inputs), run.plain(*inputs), dname,
                    1e-4 if run.kind == "dot" else 0.0)
        row = rows[run.kernel_id]
        row["err"] = max(row["err"], e)
        plain_ms = cuda_ms(lambda: run.plain(*inputs), 2)
        reset_launch_counts()
        m = vpu.measure(run, inputs)
        n = launch_counts()[run.kernel_id]
        print(json.dumps({**m, "plain_ms": plain_ms, "launches": n}), flush=True)
        add(row, m, plain_ms, n)
        del inputs
        torch.cuda.empty_cache()

    t1 = rows["T1"]
    for label, shape, co in fold.SITES:
        for dtype in (torch.float32, torch.bfloat16):
            inp = fold.site_inputs(shape, co, gen, dtype)
            for r in fold.check(inp):
                print(f"check T1 conv3d_dslice_v2 {label} {dtype} ab={r['ab']} relu={r['relu']}: "
                      f"max_abs_err {r['max_abs_err']:.3e}, worst error / allowance {r['worst_ratio']:.3f}",
                      flush=True)
                if not r["worst_ratio"] <= 1.0:
                    fail(f"T1 {label} {dtype}: kernel disagrees with its plain version")
                if dtype == torch.bfloat16:
                    t1["err"] = max(t1["err"], r["max_abs_err"])
            if dtype == torch.bfloat16:
                plain_ms = cuda_ms(lambda: conv3d_dslice_v2_plain(inp["x"], inp["wmat"], inp["ab"], relu=True), 1)
                reset_launch_counts()
                m = fold.measure(label, inp)
                n = launch_counts()["T1"]
                print(json.dumps({**m, "plain_ms": plain_ms, "launches": n}), flush=True)
                add(t1, {**m, "ms": m["t1_ms"], "library_ms": m["cudnn_conv_ms"]}, plain_ms, n)
            del inp
            torch.cuda.empty_cache()
    for k, row in rows.items():
        if row["launches"] == 0:
            fail(f"{k} was not launched by its tool's measurement")
    return rows


def check_results(torch, res, b, h, w):
    shapes = {"pred_depth": (b, 1, h, w), "pred_normal": (b, 1, h, w, 3), "ref_feature": (b, h // 4, w // 4)}
    for key, shape in shapes.items():
        t = res[key]
        if tuple(t.shape) != shape:
            fail(f"{key}: shape {tuple(t.shape)} != {shape}")
        if not bool(torch.isfinite(t.float()).all()):
            fail(f"{key}: non-finite values")
    if res["prob_depth"] is not None:
        fail("prob_depth must be None under the fused regression")


def serve_full_width(torch, config, sd, card):
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch

    pred = Predictor(config, state_dict=sd, device="cuda", dtype=torch.bfloat16)
    batches = [bench_batch(B, H, W, seed=s) for s in range(3)]
    check_results(torch, pred(batches[0]), B, H, W)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    reset_launch_counts()
    smoke = timed(pred, batches, check=lambda res: check_results(torch, res, B, H, W))
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), "K1": 2 * len(batches), "K3": len(batches), "K5": 2 * len(batches)}
    print(f"serving launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}: the serving path did not run through every kernel")
    # 3 batches: a smoke reading only; the serving rate is profile_serving's,
    # over many more batches through the same `timed`
    print(json.dumps({"serving_smoke": {**smoke, "batch": B, "hw": [H, W], "dtype": "bfloat16",
                                        "card": card}}), flush=True)
    return launches


def check_against_cpu(torch, config, sd):
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch

    batch = bench_batch(1, 192, 192, seed=7)
    gpu = Predictor(config, state_dict=sd, device="cuda", dtype=torch.float32)(batch)
    cpu = Predictor(config, state_dict=sd, device="cpu", dtype=torch.float32)(batch)
    check_results(torch, gpu, 1, 192, 192)
    d_err = float((gpu["pred_depth"].cpu() - cpu["pred_depth"]).abs().max())
    n_diff = (gpu["pred_normal"].cpu() - cpu["pred_normal"]).abs()
    n_share = float((n_diff <= 1e-3).float().mean())
    n_mean = float(n_diff.mean())
    print(f"192x192 f32 card vs CPU: depth max_abs_err {d_err:.3e} (tol 1e-2); normals within 1e-3: "
          f"{n_share:.5f} (tol >= 0.995), mean abs err {n_mean:.3e} (tol 1e-3)", flush=True)
    # depth: f32 sums in another order through ~60 layers, then a softmax
    # over 32 bins; normals: a pixel whose disparity sits at a plane boundary
    # may pick the other sample_with_sort window, so a small share may differ
    if not (d_err <= 1e-2 and n_share >= 0.995 and n_mean <= 1e-3):
        fail("the card's forward disagrees with the CPU forward at 192x192")


def train_full_width(torch, sd, card):
    """Phase 7: 3 train steps in the train cell (batch 2 at 768x576 under
    the bf16 policy: `profile_train.TRAIN_CELL`'s run keys)."""
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.ops.precision import resolve_policy
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.profile_train import TRAIN_CELL, train_batch
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step

    config = load_config("stereodpnet_plus", run_overrides=TRAIN_CELL)
    if (resolve_policy(config), config.batch_size) != (torch.bfloat16, TB):
        fail(f"the train cell's run keys give {resolve_policy(config)}, batch {config.batch_size}")
    state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device="cuda")
    step = make_train_step(state.model, loss_selector(config), resolve_policy(config))
    batches = [train_batch(TB, H, W, seed=s) for s in range(3)]

    def check(losses):
        if set(losses) != {"smoothL1_loss", "cosine_loss", "final_loss"}:
            fail(f"train step losses {sorted(losses)}")
        for k, v in losses.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"train step {k} is not finite: {v}")

    check(step(state, train_batch(TB, H, W, seed=3))[1])  # warm-up (cuDNN plans, allocator)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    smoke = timed(lambda b: step(state, b)[1], batches, check=check)
    launches = launch_counts()
    per_step = {"K1": 2, "K2": 2, "K3": 3, "K4": 3, "K5": 2}
    want = {**dict.fromkeys(launches, 0), **{k: n * len(batches) for k, n in per_step.items()}}
    print(f"train launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}: the train path did not run through every kernel")
    masters = [p for g in state.optimizer.param_groups for p in g["params"]]
    params = list(state.model.parameters())
    if len(params) != len(masters) or any(p is not q or p.dtype != torch.float32 for p, q in zip(params, masters)):
        fail("the model's parameters are no longer the optimizer's f32 masters after the bf16 steps")
    moved = sum(int(not torch.equal(p.detach(), before[n])) for n, p in state.model.named_parameters())
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameter tensors moved in 3 train steps")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"train_smoke": {**smoke, "batch": TB, "hw": [H, W], "dtype": "bfloat16",
                                      "peak_memory_gb": peak, "params_moved": moved, "params": len(before),
                                      "card": card}}), flush=True)
    return launches


def kink_log(torch):
    """A torch function mode that records, in call order, each decision of
    a step that switches its gradient: the side of 0 of every ReLU input,
    every `torch.where` condition (PReLU, LeakyReLU, the losses' branches),
    every floor (the ANM's plane window; the deform convs' sampling
    positions, as the floor of their offsets, from `watch(model)`), and the
    operand every elementwise maximum / minimum takes (the offset clamp,
    whose bound sets the aperture's 0.5, the cosine clip, the ASM's
    softmax). Calls from the kernels' plain versions (the CPU run) are left
    out: on the card those decisions are made inside the kernels."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    kernels_dir = str(ROOT / "dualpixelface_tpu_torch" / "ops" / "kernels")

    def in_kernel_wrapper():
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.startswith(kernels_dir):
                return True
            f = f.f_back
        return False

    class KinkLog(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.decisions = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.relu, F.relu, torch.Tensor.relu):
                d = args[0] > 0
            elif func is torch.where and len(args) == 3:
                d = args[0]
            elif func in (torch.floor, torch.Tensor.floor):
                d = out
            elif func in (torch.maximum, torch.minimum):
                d = torch.sign(args[0] - args[1])
            else:
                return out
            if not in_kernel_wrapper():
                self.decisions.append(d.detach().to("cpu", torch.float32))
            return out

        def watch(self, model):
            def hook(module, inputs, out):
                torch.floor(out[1])  # logged: the sampling positions' floors

            return [model.normal_estimator.get_submodule(f"deform_conv{i}").register_forward_hook(hook)
                    for i in (1, 2)]

    return KinkLog()


# phase 8: the views' seeds tried in order (1004 is the CPU test's point
# against JAX, tests/test_torch_train.py)
CPU_POINTS = (1004, 1008, 1009, 1000, 1002, 1007)
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def train_against_cpu(torch):
    """Phase 8: one f32 train step of batch 2 at 32x32 on the card against
    the same step on the CPU, from the committed plateau checkpoint on
    smooth views, the point tests/test_torch_train.py holds the CPU step
    against JAX at (why that point, in its fixture's docstring).

    A kink whose input lies within f32 rounding of its switch point can
    take one side on the card and the other on the CPU; the gradient then
    jumps by 1e-3 to 1e-1 upstream, whatever the precision, and that point
    tells nothing either way. So both runs log every kink decision
    (`kink_log`), and the phase holds the first point of CPU_POINTS where
    card and CPU decided alike everywhere: losses within 1e-4 of their
    value, each parameter's gradient within 1e-3 of its norm, and the two
    deform-conv biases (exact gradient zero: each feeds a batch-statistics
    BatchNorm) within 1e-6 of their weight's gradient norm on both. A point
    with differing decisions is reported and passed over; the phase fails
    if every point has them."""
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.ops.precision import resolve_policy
    from dualpixelface_tpu_torch.profile_train import smooth_views, train_batch
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step
    from dualpixelface_tpu_torch.weights import read_flax_msgpack, state_dict_from_jax

    config = load_config("stereodpnet_plus")  # the default run keys: the f32 policy
    tree = read_flax_msgpack(ROOT / "tests" / "data" / "serving_plateau_192.msgpack")
    sd = state_dict_from_jax(tree["params"], tree["batch_stats"])

    def step(dev, batch):
        state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device=dev)
        log = kink_log(torch)
        hooks = log.watch(state.model)
        with log:
            state, losses = make_train_step(state.model, loss_selector(config), resolve_policy(config))(state, batch)
        for h in hooks:
            h.remove()
        return ({k: float(v) for k, v in losses.items()},
                {n: p.grad.detach().double().cpu() for n, p in state.model.named_parameters()}, log.decisions)

    for seed in CPU_POINTS:
        batch = {**train_batch(2, 32, 32), **smooth_views(2, 32, 32, seed)}
        (lg, gg, dg), (lc, gc, dc) = step("cuda", batch), step("cpu", batch)
        if len(dg) != len(dc) or any(a.shape != b.shape for a, b in zip(dg, dc)):
            fail(f"phase 8: the card and the CPU logged different kink sequences ({len(dg)} vs {len(dc)})")
        flips = sum(int((a != b).sum()) for a, b in zip(dg, dc))
        print(f"32x32 f32 train step, views seed {seed}: {len(dc)} kink sites, "
              f"{sum(a.numel() for a in dc)} decisions, {flips} differ between card and CPU", flush=True)
        if flips:
            continue
        loss_err = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
        rel = {n: float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc if n not in ZERO_GRAD}
        zero = max(float(max(gg[n].norm(), gc[n].norm()) / gc[n.replace(".bias", ".weight")].norm())
                   for n in ZERO_GRAD)
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        print(f"  card vs CPU: losses rel err {loss_err:.3e} (tol 1e-4); gradients per parameter: median "
              f"{sorted(rel.values())[len(rel) // 2]:.3e}, largest {worst} (tol 1e-3); zero-gradient biases "
              f"{zero:.3e} of their weight's (tol 1e-6)", flush=True)
        if not (loss_err <= 1e-4 and worst[0][1] <= 1e-3 and zero <= 1e-6):
            fail("the card's train step disagrees with the CPU's at 32x32")
        return
    fail(f"phase 8: card and CPU took another side of some kink at every point of {CPU_POINTS}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "dualpixelface_tpu_torch" / "csrc").is_dir():
        print(f"FAIL: the port's package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.ops.kernels import _build
    from dualpixelface_tpu_torch.serve import seeded_state_dict
    from dualpixelface_tpu_torch.tools import PEAK_BF16, PEAK_F32, PEAK_SFU, bound_ms

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + json.dumps({k: round(v["seconds"], 1) for k, v in report.items()}), flush=True)
    print_build_report(report)

    err, timing = check_and_time_kernels(torch)
    check_and_time_backward_kernels(torch, err, timing)
    check_and_time_softargmin(torch, err, timing)
    check_edge_shapes(torch)
    config = load_config("stereodpnet_plus")
    sd = seeded_state_dict(config)
    serving = serve_full_width(torch, config, sd, card)
    check_against_cpu(torch, config, sd)
    launches = train_full_width(torch, sd, card)
    train_against_cpu(torch)
    tools = tools_phase(torch)
    k5, t1 = timing["K5"], tools["T1"]
    chain_ms = sum(r["chain_ms"] for r in t1["runs"])
    print(json.dumps({"yardsticks": {
        "K5_bf16_ms": k5["ms"], "K5_cudnn_best_ms": k5["library_ms"],
        "K5_cudnn_layouts": [r["cudnn_layout"] for r in k5["runs"]], "K5_no_slower": k5["ms"] <= k5["library_ms"],
        "T1_bf16_ms": t1["ms"], "T1_chain_ms": chain_ms, "T1_no_slower": t1["ms"] <= chain_ms, "card": card}}),
        flush=True)

    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5"):
        t = timing[k]
        # contractions at their type's peak, other f32 work on the CUDA
        # cores, exps on the special-function units
        b_ms, b_by = bound_ms(t["bytes"], (t["flops"], PEAK_BF16), (t.get("flops_f32", 0.0), PEAK_F32),
                              (t.get("exps", 0.0), PEAK_SFU))
        kernels.append({
            "name": f"{k} {NAMES[k]}", "route": "cuda",
            "source": f"dualpixelface_tpu_torch/csrc/{SOURCES[k]}", "replaces": TPU_SITES[k],
            "launches": launches[k], "launches_serving": serving[k], "max_abs_err": err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library_ms"],
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {}),
        })
    for k, row in tools.items():
        kernels.append({
            "name": f"{k} {NAMES[k]}", "route": "cuda",
            "source": f"dualpixelface_tpu_torch/csrc/{SOURCES[k]}", "replaces": TPU_SITES[k],
            "launches": row["launches"], "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": "operations" if 2 * row["bound_ops_ms"] >= row["bound_ms"] else "bytes",
            "library_ms": row["library_ms"], "runs": len(row["runs"]),
        })
    print(json.dumps({"work": {k: {key: v for key, v in timing[k].items() if key.startswith(("flops", "bytes", "exps"))}
                               for k in timing}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
