"""Device ms a request batch of the program's `asm.gate` spans (the ASM's
mode statistics, activation, softmax over the modes and gated mean, both
views), by their CUDA events, summed over the window's calls and divided by
their number.

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
    calls = spans.get("serve.call", {}).get("calls")
    value = spans.get("asm.gate", {}).get("device_ms")
    return value / calls if calls and value is not None else None
