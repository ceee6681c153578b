"""The program's own tracer (`utils/profiling`), as the readers of its
spans see it (`benchmark/metrics/nnet_serve.*.py`).

Importing this module turns the tracer on (`enable()`, annotations off, so
the profiler slice holds no range of the program's); the harness imports a
traced run's readers before its window and never in an untraced run
(`benchmark/run.py`, `measure`). Spans are not timed while the slice's
profiler records. Where the program has no tracer, or the run no such span,
a reading is None."""
from __future__ import annotations

from dualpixelface_tpu_torch.utils import profiling

if hasattr(profiling, "enable"):
    profiling.enable()


def device_ms_per_call(name: str) -> float | None:
    """The span's device ms (its CUDA events, summed over the window's
    calls) over the calls of `serve.call`."""
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    calls = spans.get("serve.call", {}).get("calls")
    value = spans.get(name, {}).get("device_ms")
    return value / calls if calls and value is not None else None
