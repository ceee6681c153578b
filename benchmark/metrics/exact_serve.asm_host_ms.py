"""Host ms a request batch spends in the program's `model.cost_volume` span
(the ASM cost volume), over the window's calls: set beside the stage's
device time (`exact_serve.asm_ms`), whether the ASM is paced by the host's issue.

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
    value = spans.get("model.cost_volume", {}).get("host_ms")
    return value / calls if calls and value is not None else None
