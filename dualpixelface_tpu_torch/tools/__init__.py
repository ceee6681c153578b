"""Counterparts of the JAX package's measurement tools that run TPU
kernels, on the card:

    python3 -m dualpixelface_tpu_torch.tools.bench_vpu_prims    # T2-T4 (tools/bench_vpu_prims.py)
    python3 -m dualpixelface_tpu_torch.tools.bench_dslice_fold  # T1 (tools/bench_dslice_fold.py --module convbn)

and of the port's own: `bench_k2_split`, `bench_k1_split`,
`bench_k4_split` and `bench_t1_split`, where K2's, K1's, K4's and T1's f32
time goes (builds of each that leave one part out), `bench_softargmin`,
K3's and K4's device time in this tree or another, and `bench_tools_f32`,
T1's and T4's f32 routes in this tree or another. All
need a GPU and fail without one. Shared here: the H100's peak rates and the
timing and bound helpers."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import subprocess
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, TF32 tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# exp2 on the special-function units (MUFU): 16 per clock per SM on sm_90
# (CUDA C++ Programming Guide, arithmetic instruction throughput), on 132 SMs
# at the 1.98 GHz boost clock behind the 67 TFLOP/s f32 peak.
PEAK_SFU = 132 * 16 * 1.98e9


def require_cuda(tool: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool} measures the card and needs a GPU; CUDA is not available")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms of `fn()` over `iters` launches after `warmup`, with
    CUDA events around the whole run."""
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


def device_busy_us(events) -> float:
    """The union of the device intervals of profiler `events`, in us: time
    the card was busy, counting overlapping kernels once."""
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy += e.time_range.end - start
        end = max(end, e.time_range.end)
    return busy


_PROFILE_ATTEMPTS = 3


def device_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms of `fn()` over `iters` calls after `warmup`: the union
    of the device intervals (kernels, memsets, copies) that torch.profiler
    records for the calls, over `iters`. Unlike `cuda_ms` it leaves out the
    host's dispatch between launches. A profiling session that records no
    device activity at all (seen now and then on an H100 80GB HBM3, in a
    fresh process too) is run again, up to `_PROFILE_ATTEMPTS` sessions in
    all."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(_PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return device_busy_us(events) / 1e3 / iters
    raise RuntimeError(f"device_ms: the profiler recorded no device activity in {_PROFILE_ATTEMPTS} sessions")


def cudnn_conv3d_calls(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> dict:
    """The yardstick of K5 and T1, one call per memory layout: the
    library's 3x3x3 pad-1 conv (cuDNN) of x [B, D, H, W, C] by weight
    [3, 3, 3, C, Co] on NCDHW copies ("ncdhw") and on x's own NDHWC memory
    viewed as NCDHW ("channels_last_3d"). The port never calls it."""
    x_cf = x.permute(0, 4, 1, 2, 3)
    w_cf = weight.permute(4, 3, 0, 1, 2)
    operands = {"ncdhw": (x_cf.contiguous(), w_cf.contiguous()),
                "channels_last_3d": (x_cf, w_cf.contiguous(memory_format=torch.channels_last_3d))}
    return {name: functools.partial(torch.nn.functional.conv3d, a, w, bias, padding=1)
            for name, (a, w) in operands.items()}


def bound_ms(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least ms for the work: the larger of its bytes over the memory
    rate and, over each (operations, peak rate) pair of `work`, the
    operations over their peak rate; and which of the two kinds it is."""
    t_ops = max((ops / peak * 1e3 for ops, peak in work), default=0.0)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def build_variants(source: str, csrc: Path, tag: str, variants: dict[str, list[str]]) -> dict[str, ctypes.CDLL]:
    """Build the kernel source text `source` (which includes the headers of
    `csrc`) once per variant, with that variant's extra nvcc flags, all at
    once, into `<tag>/<hash of the source>/` beside the kernels' build
    directory; returns each variant's loaded library."""
    from dualpixelface_tpu_torch.ops.kernels import _build

    out = _build.BUILD_DIR.parent / tag / hashlib.sha256(source.encode()).hexdigest()[:12]
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel.cu").write_text(source)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {v: subprocess.Popen([_build._nvcc(), *_build._NVCC_FLAGS, *flags, "-o", str(out / f"lib{v}.so"),
                                  str(out / "kernel.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, flags in variants.items()}
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {v} of {out}:\n{log}")
        libs[v] = ctypes.CDLL(str(out / f"lib{v}.so"))
    return libs
