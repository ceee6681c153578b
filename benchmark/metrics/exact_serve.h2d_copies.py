"""Host-to-device copies a request batch (the program's `h2d.copies`
counter over the calls of `serve.call`, those of the profiler slice
included): the request's arrays and every per-call constant copied from
the host.

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
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {"spans": {}, "counters": {}}
    outer = snap["spans"].get("serve.call")
    value = snap["counters"].get("h2d.copies")
    if not outer or value is None:
        return None
    calls = outer["calls"] + outer["untimed"]  # the slice's calls copy too
    return value / calls if calls else None
