"""Host ms a train step spends in the program's `train.h2d` span (`batch_to`:
the copy of the batch's host arrays), over the window's steps.

Importing this file turns the program's tracer on (`utils/profiling`'s
`enable()`, annotations off, so the profiler slice holds no range of the
program's); the harness imports a traced run's readers before its window
and never in an untraced run (`benchmark/run.py`, `measure`). Spans are
not timed while the slice's profiler records. Where the program has no
tracer, or the run no such span or counter, it reads None."""
from dualpixelface_tpu_torch.utils import profiling

if hasattr(profiling, "enable"):
    profiling.enable()


def read(r):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    calls = spans.get("train.step", {}).get("calls")
    value = spans.get("train.h2d", {}).get("host_ms")
    return value / calls if calls and value is not None else None
