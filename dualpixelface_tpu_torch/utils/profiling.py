"""Profiling, timing and the port's tracer (counterpart of
`dualpixelface_tpu/utils/profiling.py`).

`trace(logdir)` wraps a region in a `torch.profiler` trace of the host and,
when the process uses the card, of the device, written into `logdir` as a
Chrome trace that TensorBoard's profiler plugin reads (the reference's
always-on PL profiler, ref main.py:57). `timeit` is the mean seconds per
call, synchronised with the card.

The tracer times the program's layers from inside:

    with span("model.cost_volume"):      # at a layer boundary
        ...
    count("h2d.copies")                  # where the work happens
    t = to_device(array, device)         # a counted host-to-device copy

* `span(name)` is off by default: it returns one shared no-op object and
  records nothing. After `enable()` each span records its name, its
  parent span, its call (the sequence number of the outermost span open,
  `serve.call` or `train.step`, shared by every span inside it), its start
  and end on the host clock and, while CUDA is initialised, a pair of CUDA
  events (none while the current stream captures a CUDA graph). Device times are read without a synchronise: at each outermost
  span's start, the calls the card has finished are read with `query()`
  and their events reused. While a `torch.profiler` session records, spans
  are not timed (the profiler's cost stays out of the statistics); with
  `enable(annotate=True)` each then opens a `record_function` range under
  its name, so the profiler's trace holds the program's spans beside the
  kernels they launched. Spans are opened from one thread.
* `count(name, n)` counters are always on: `h2d.copies`, `h2d.bytes` and
  `h2d.pageable_bytes` (`to_device`), `launch.K1` ... `launch.T4` (the
  kernel wrappers), `kernels.build` and `kernels.load` (`ops/kernels/_build`),
  `serve.graph_captures` and `serve.graph_replays` (`utils/graphs`).
* `snapshot()` sums both since `enable()`: {"spans": {name: {calls,
  untimed, host_ms, self_host_ms, device_ms}}, "counters": {...}}, where
  `calls` are the timed entries, `untimed` those made while a profiler
  recorded, self time is a span's host time less its children's, and
  `device_ms` is None where no event pair was read. `write(path)` puts the
  snapshot and the last RING span records into one JSON file.

Who reads them: the benchmark's per-layer readers (`benchmark/metrics/`),
`profile_serving`, `profile_train` and `main.py --profile`.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time

import torch

RING = 4096  # span records kept for `write`
MAX_PENDING = 64  # calls whose device times wait for the card; past it the oldest is waited for


class _Off:
    """The span of a tracer that is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_tracer = None  # the enabled _Tracer, or None
_counts: dict[str, int] = {}


class _Stat:
    __slots__ = ("calls", "untimed", "host_ns", "self_ns", "device_ms", "device_n")

    def __init__(self):
        self.calls = self.untimed = self.host_ns = self.self_ns = self.device_n = 0
        self.device_ms = 0.0


def _device_stream():
    """The stream a call's CUDA event pairs go on, the one current at its
    outermost span's start; None (no device times) where the process has
    not set up CUDA. Taken once a call: asking for it costs the host more
    than a record does."""
    return torch.cuda.current_stream() if torch.cuda.is_initialized() else None


def _capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph: a span opened
    then records no CUDA event (a capture may not hold one on another
    stream, and a replay would not repeat it)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _device_event():
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("tracer", "stat", "record", "child_ns", "events")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.stat = tracer.stat(name)
        self.child_ns = 0
        self.events = None
        self.record = [name, None, None, 0, 0, None]  # name, parent, call, start ns, end ns, device ms

    def __enter__(self):
        tr = self.tracer
        rec = self.record
        if tr.stack:
            outer = tr.stack[-1]
            rec[1], rec[2] = outer.record[0], outer.record[2]
        else:
            tr.resolve()
            tr.seq += 1
            rec[2] = tr.seq
            tr.stream = _device_stream()
            tr.call_events = []
        tr.stack.append(self)
        if tr.stream is not None and not _capturing():
            self.events = (tr.event(), tr.event())
            self.events[0].record(tr.stream)
        rec[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        rec = self.record
        rec[4] = t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(tr.stream)
            tr.call_events.append((self.stat, rec, *self.events))
        tr.stack.pop()
        host = t1 - rec[3]
        st = self.stat
        st.calls += 1
        st.host_ns += host
        st.self_ns += host - self.child_ns
        if tr.stack:
            tr.stack[-1].child_ns += host
        elif tr.call_events:
            tr.pending.append((self.events[1], tr.call_events))
            if len(tr.pending) > MAX_PENDING:
                tr.pending[0][0].synchronize()
                tr.resolve()
        tr.ring.append(rec)
        return False


class _Tracer:
    """The spans' statistics and records while the tracer is on."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.stats: dict[str, _Stat] = {}
        self.stack: list[_Span] = []
        self.seq = 0
        self.stream = None
        self.call_events: list = []
        self.pending: collections.deque = collections.deque()  # (the call's last event, its span events)
        self.free: list = []
        self.ring: collections.deque = collections.deque(maxlen=RING)

    def stat(self, name: str) -> _Stat:
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = _Stat()
        return st

    def span(self, name: str):
        if torch.autograd._profiler_enabled():
            self.stat(name).untimed += 1
            return torch.autograd.profiler.record_function(name) if self.annotate else _OFF
        return _Span(self, name)

    def event(self):
        return self.free.pop() if self.free else _device_event()

    def resolve(self) -> None:
        """Read the device times of the calls the card has finished, oldest
        first, and return their events to the pool."""
        while self.pending and self.pending[0][0].query():
            _, spans = self.pending.popleft()
            for st, rec, start, end in spans:
                ms = start.elapsed_time(end)
                rec[5] = ms
                st.device_ms += ms
                st.device_n += 1
                self.free += (start, end)


def span(name: str):
    """A context manager around one layer's work (see the module's
    docstring); the shared no-op while the tracer is off."""
    if _tracer is None:
        return _OFF
    return _tracer.span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (always on)."""
    _counts[name] = _counts.get(name, 0) + n


def enable(annotate: bool = False) -> None:
    """Turn the tracer on, its statistics and the counters at zero."""
    global _tracer
    _tracer = _Tracer(annotate)
    _counts.clear()


def disable() -> None:
    """Turn the spans off; the counters keep counting."""
    global _tracer
    _tracer = None


def reset() -> None:
    """The spans' statistics and the counters at zero."""
    if _tracer is not None:
        enable(_tracer.annotate)
    _counts.clear()


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counts)


def reset_counters(prefix: str) -> None:
    """The counters whose names start with `prefix` at zero."""
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


def snapshot() -> dict:
    """The spans' statistics and the counters since `enable()`; device
    times of the calls the card has not finished are left out."""
    spans = {}
    if _tracer is not None:
        _tracer.resolve()
        for name, st in _tracer.stats.items():
            spans[name] = {"calls": st.calls, "untimed": st.untimed, "host_ms": st.host_ns / 1e6,
                           "self_host_ms": st.self_ns / 1e6, "device_ms": st.device_ms if st.device_n else None}
    return {"spans": spans, "counters": counters()}


def records() -> list[dict]:
    """The last RING span records, oldest first."""
    if _tracer is None:
        return []
    _tracer.resolve()
    keys = ("name", "parent", "call", "start_ns", "end_ns", "device_ms")
    return [dict(zip(keys, rec)) for rec in _tracer.ring]


def write(path) -> None:
    """The snapshot and the span records as one JSON file at `path`."""
    with open(path, "w") as f:
        json.dump({**snapshot(), "records": records()}, f)


def to_device(a, device, dtype=None, non_blocking: bool = False) -> torch.Tensor:
    """`a` as a tensor on `device`: `torch.as_tensor(a, dtype=dtype,
    device=device)`, or for a tensor `a.to(device, dtype, non_blocking)`.
    Host data (numpy, a Python value or a CPU tensor) counts as one
    host-to-device copy of the result's bytes, pageable unless `a` is a
    pinned tensor; on a CPU run the site counts the same, though nothing
    crosses a bus."""
    if torch.is_tensor(a):
        host = a.device.type == "cpu"
        pinned = host and a.is_pinned()
        t = a.to(device=device, dtype=dtype, non_blocking=non_blocking)
    else:
        host, pinned = True, False
        t = torch.as_tensor(a, dtype=dtype, device=device)
    if host:
        nbytes = t.numel() * t.element_size()
        count("h2d.copies")
        count("h2d.bytes", nbytes)
        if not pinned:
            count("h2d.pageable_bytes", nbytes)
    return t


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
