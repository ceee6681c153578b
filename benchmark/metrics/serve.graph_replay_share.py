"""Share of the request batches whose front stages (the feature tower, the
ASM cost volume and the aggregation) replayed from CUDA graphs, in %: the
program's `serve.graph_replays` counter (one per stage and call) over
STAGES times the calls of `serve.call`, those of the profiler slice
included.

Importing this file turns the program's tracer on (`utils/profiling`'s
`enable()`, annotations off, so the profiler slice holds no range of the
program's); the harness imports a traced run's readers before its window
and never in an untraced run (`benchmark/run.py`, `measure`). Spans are
not timed while the slice's profiler records. Where the program has no
tracer, or the run no such span or counter, it reads None."""
from dualpixelface_tpu_torch.utils import profiling

if hasattr(profiling, "enable"):
    profiling.enable()

STAGES = 3  # the stages StereoDPNet declares for graphs


def read(r):
    snap = profiling.snapshot() if hasattr(profiling, "snapshot") else {"spans": {}, "counters": {}}
    outer = snap["spans"].get("serve.call")
    value = snap["counters"].get("serve.graph_replays")
    if not outer or value is None:
        return None
    calls = outer["calls"] + outer["untimed"]  # the slice's calls replay too
    return 100.0 * value / (STAGES * calls) if calls else None
