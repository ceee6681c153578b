"""Profiling and timing (counterpart of `dualpixelface_tpu/utils/profiling.py`).

`trace(logdir)` wraps a region in a `torch.profiler` trace of the host and,
when the process uses the card, of the device, written into `logdir` as a
Chrome trace that TensorBoard's profiler plugin reads (the reference's
always-on PL profiler, ref main.py:57). `timeit` is the mean seconds per
call, synchronised with the card.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Wrap a region in a torch.profiler trace written to `logdir`
    (a no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Mean seconds per call of `fn(*args)`, the card synchronised before
    the clock starts and after the last call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters
