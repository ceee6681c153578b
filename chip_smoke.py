#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from `dualpixelface_tpu_torch/csrc/`
     (one nvcc per source, all at once) and print the build seconds;
  3. check each kernel against its plain PyTorch version on the same seeded
     CUDA tensors at the serving path's shapes, in bf16 and f32 (TF32 off);
  4. time each kernel, its plain version and, for K5, cuDNN's conv3d (which
     the port never calls) with CUDA events;
  5. serve 3 request batches of 4 dual-pixel pairs at 768x576 in bf16
     through `Predictor` (seeded weights, non-zero offset heads): shapes,
     finiteness, launch counts (K1 +2, K5 +2, K3 +1 per forward), and a
     smoke reading of pairs/s (the serving rate proper, over many batches,
     is `python3 -m dualpixelface_tpu_torch.profile_serving`'s);
  6. the same weights at 192x192, batch 1, f32: the card's forward (kernels)
     against the CPU forward (plain versions).
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Serving path shapes (stereodpnet_plus at 768x576, batch 4): the ANM volume
# is [B, K=4, H/4, W/4, C] with C = 35 into deform_conv1, 64 into deform_conv2.
B, H, W = 4, 768, 576
ANM_SHAPE = (B, 4, H // 4, W // 4)
CINS = (35, 64)
COUT = 64
REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # of max(1, max|plain|)

TPU_SITES = {
    "K1": "dualpixelface_tpu/ops/kernels/deform_fused.py:598",
    "K3": "dualpixelface_tpu/ops/kernels/fused_softargmin.py:238",
    "K5": "dualpixelface_tpu/ops/kernels/conv3d_dslice.py:207",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, ref, dtype_name: str) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = REL_TOL[dtype_name] * max(1.0, float(ref.abs().max()))
    print(f"check {name} {dtype_name}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        fail(f"{name} {dtype_name}: kernel disagrees with its plain version: {err} > {tol}")
    return err


def kernel_inputs(torch, gen, cin, dtype):
    dev = "cuda"
    x = torch.randn(ANM_SHAPE + (cin,), generator=gen, device=dev).to(dtype)
    off = torch.randn(ANM_SHAPE + (81,), generator=gen, device=dev) * 2.0
    # a quarter of the offsets are whole numbers: positions exactly on the grid
    whole = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(whole, torch.round(off), off).to(dtype)
    w = (torch.randn((3, 3, 3, cin, COUT), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    bias = torch.randn((COUT,), generator=gen, device=dev).to(dtype)
    w_off = (torch.randn((3, 3, 3, cin, 81), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    b_off = torch.randn((81,), generator=gen, device=dev).to(dtype)
    return x, off, w, bias, w_off, b_off


def check_and_time_kernels(torch):
    from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice, conv3d_dslice_plain
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import deform_conv3d_fused, deform_conv3d_plain
    from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import fused_softargmin, fused_softargmin_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    err = {"K1": 0.0, "K3": 0.0, "K5": 0.0}
    timing = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0, "bytes": 0.0} for k in err}

    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in CINS:
            x, off, w, bias, w_off, b_off = kernel_inputs(torch, gen, cin, dtype)
            for aperture in (True, False):
                e = compare(f"K1 deform_conv3d_fused Cin={cin} aperture={aperture}",
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
            k1["ms"] += cuda_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5)
            k1["plain_ms"] += cuda_ms(lambda: deform_conv3d_plain(x, off, w, bias, aperture=True), 2)
            m = math.prod(ANM_SHAPE)
            k1["flops"] += 2.0 * m * 27 * cin * COUT
            k1["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w, bias)) + m * COUT * 2
            k5 = timing["K5"]
            k5["ms"] += cuda_ms(lambda: conv3d_dslice(x, w_off, b_off), 5)
            k5["plain_ms"] += cuda_ms(lambda: conv3d_dslice_plain(x, w_off, b_off), 2)
            x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
            w_cf = w_off.permute(4, 3, 0, 1, 2).contiguous()
            lib = cuda_ms(lambda: torch.nn.functional.conv3d(x_cf, w_cf, b_off, padding=1), 5)
            k5["library_ms"] = (k5["library_ms"] or 0.0) + lib
            k5["flops"] += 2.0 * m * 27 * cin * 81
            k5["bytes"] += sum(t.numel() * t.element_size() for t in (x, w_off, b_off)) + m * 81 * 2

    disp = regression_disparities(-4, 12, 8, 4)
    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for hw in ((H // 4, W // 4), (50, 36)):  # the serving shape; 4h % 32 != 0
            cost = (torch.randn((B, 8) + hw, generator=gen, device="cuda") * 3.0).to(dtype)
            e = compare(f"K3 fused_softargmin h,w={hw}", fused_softargmin(cost, disp, 4),
                        fused_softargmin_plain(cost, disp, 4), dname)
            if dtype == bf16 and hw == (H // 4, W // 4):
                err["K3"] = e
                k3 = timing["K3"]
                k3["ms"] = cuda_ms(lambda: fused_softargmin(cost, disp, 4), 20)
                k3["plain_ms"] = cuda_ms(lambda: fused_softargmin_plain(cost, disp, 4), 5)
                d, h, w = 8, hw[0], hw[1]
                npix = B * 16 * h * w
                # per output pixel: 2x2 interpolation of D planes (9 ops each),
                # per bin a 2-tap D interpolation and the online softmax update
                k3["flops"] = npix * (9.0 * d + 9.0 * 4 * d + 1.0)
                k3["bytes"] = cost.numel() * cost.element_size() + npix * 2
    return err, timing


def bound(entry, peak_flops):
    t_ops = entry["flops"] / peak_flops * 1e3
    t_bytes = entry["bytes"] / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    from dualpixelface_tpu_torch.ops.kernels import kernel_wrappers, reset_launch_counts
    from dualpixelface_tpu_torch.profile_serving import serve_timed
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch

    pred = Predictor(config, state_dict=sd, device="cuda", dtype=torch.bfloat16)
    batches = [bench_batch(B, H, W, seed=s) for s in range(3)]
    check_results(torch, pred(batches[0]), B, H, W)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    reset_launch_counts()
    smoke = serve_timed(pred, batches, check=lambda res: check_results(torch, res, B, H, W))
    k1, k3, k5 = (fn.launches for fn in kernel_wrappers())
    launches = {"K1": k1, "K3": k3, "K5": k5}
    want = {"K1": 2 * len(batches), "K3": len(batches), "K5": 2 * len(batches)}
    print(f"serving launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}: the serving path did not run through every kernel")
    # 3 batches: a smoke reading only; the serving rate is profile_serving's,
    # over many more batches through the same serve_timed
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

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + json.dumps({k: round(v["seconds"], 1) for k, v in report.items()}), flush=True)
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    err, timing = check_and_time_kernels(torch)
    config = load_config("stereodpnet_plus")
    sd = seeded_state_dict(config)
    launches = serve_full_width(torch, config, sd, card)
    check_against_cpu(torch, config, sd)

    sources = {"K1": "deform_conv3d.cu", "K3": "fused_softargmin.cu", "K5": "conv3d_dslice.cu"}
    names = {"K1": "deform_conv3d_fused", "K3": "fused_softargmin", "K5": "conv3d_dslice"}
    kernels = []
    for k in ("K1", "K3", "K5"):
        t = timing[k]
        b_ms, b_by = bound(t, PEAK_F32 if k == "K3" else PEAK_BF16)
        kernels.append({
            "name": f"{k} {names[k]}", "route": "cuda",
            "source": f"dualpixelface_tpu_torch/csrc/{sources[k]}", "replaces": TPU_SITES[k],
            "launches": launches[k], "max_abs_err": err[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library_ms"],
        })
    print(json.dumps({"work": {k: {"flops": timing[k]["flops"], "bytes": timing[k]["bytes"]} for k in timing}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
