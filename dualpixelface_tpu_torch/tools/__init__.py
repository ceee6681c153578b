"""Counterparts of the JAX package's measurement tools that run TPU
kernels, on the card:

    python3 -m dualpixelface_tpu_torch.tools.bench_vpu_prims    # T2-T4 (tools/bench_vpu_prims.py)
    python3 -m dualpixelface_tpu_torch.tools.bench_dslice_fold  # T1 (tools/bench_dslice_fold.py --module convbn)

Both need a GPU and fail without one. Shared here: the H100's peak rates
and the timing and bound helpers."""
from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


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


def bound_ms(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least ms for the work: the larger of its bytes over the memory
    rate and, over each (operations, peak rate) pair of `work`, the
    operations over their peak rate; and which of the two kinds it is."""
    t_ops = max((ops / peak * 1e3 for ops, peak in work), default=0.0)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
