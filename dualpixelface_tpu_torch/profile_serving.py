"""The serving rate of the port on the card, and where its time goes.

    python3 -m dualpixelface_tpu_torch.profile_serving [--model stereodpnet_plus] [--iters 50] [--top 25]

Runs a serving forward at the serving cell's shape (batch B = 4 at
H x W = 768 x 576, bf16, seeded weights with non-zero offset heads) after a
warm-up: `--model stereodpnet_plus` (the default) is the serving
configuration the JAX bench's headline measures (fast attention, windowed
deform with the offset clamp, fused regression); `--model stereodpnet` is
its reference-exact forward (`bench.py`'s `exact` mode: exact attention,
unbounded deform, unfused regression, so `prob_depth` is returned). It
prints, as JSON lines:
  * the serving rate (`timed` over --iters request batches);
  * each stage's device time (CUDA events around the model's top-level
    modules; the regression is the span between aggregation and the ANM);
  * the device's busy time and idle share, and the top kernels by device
    time (per forward), from torch.profiler over two forwards.
Requires a GPU; it does not run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import torch

from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.serve import Predictor, bench_batch, seeded_state_dict
from dualpixelface_tpu_torch.tools import device_busy_us

B, H, W = 4, 768, 576
MODELS = ("stereodpnet_plus", "stereodpnet")
STAGES = ("feature_extraction", "cost_volume", "aggregation", "normal_estimator")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def timed(run, batches: list, check=None) -> dict:
    """`run(batch)` for each batch, one after another, each complete (the
    card synchronised) before the next is taken, as a server answers
    requests and a trainer takes steps, each timed on the host clock.
    `check(result)` is called on each result outside the timed spans.
    Returns the pairs over the summed latencies, the number of calls, and
    the latencies' median, min and max in seconds. It gives the serving rate
    (`run` a `Predictor`) and the train rate (`run` one train step). A run
    in a process that never used the card (the CPU) has nothing to
    synchronise."""
    lat = []
    for batch in batches:
        t0 = time.perf_counter()
        res = run(batch)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if check is not None:
            check(res)
    pairs = sum(len(b["left"]) for b in batches)
    return {"pairs_per_s": pairs / sum(lat), "calls": len(batches),
            "latency_s": {"median": statistics.median(lat), "min": min(lat), "max": max(lat)}}


def stage_times(model, run) -> dict:
    """Device ms of each top-level stage of `model` during one `run()` that
    calls its forward once."""
    events = {}

    def pre(name):
        def hook(*_):
            events[name] = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
            events[name][0].record()
        return hook

    def post(name):
        def hook(*_):
            events[name][1].record()
        return hook

    handles = []
    for name in STAGES:
        mod = getattr(model, name)
        handles += [mod.register_forward_pre_hook(pre(name)), mod.register_forward_hook(post(name))]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {name: events[name][0].elapsed_time(events[name][1]) for name in STAGES}
    out["regression"] = events["aggregation"][1].elapsed_time(events["normal_estimator"][0])
    return out


def device_profile(run, reps: int, top: int, groups: dict[str, str] | None = None) -> list[dict]:
    """torch.profiler over `reps` calls of `run` (each ending on the host):
    the wall time, the device's busy time (the union of the kernels' device
    intervals) and idle share, and the `top` kernels by device time per
    call; with `groups` (name -> pattern), a last line of every kernel's
    device time per call summed by the first group whose pattern its name
    matches ("other" for none)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = device_busy_us(kernels)
    span_us = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    lines = [{"profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
              "device_idle_share_of_wall": 1.0 - busy_us / 1e3 / wall_ms,
              "device_idle_share_of_kernel_span": 1.0 - busy_us / span_us}]
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append({"kernel": name[:120], "device_ms": us / 1e3 / reps, "calls": n // reps})
    if groups:
        lines.append({"groups_ms": group_times(by_name, groups, reps)})
    return lines


def group_times(by_name: dict[str, list], groups: dict[str, str], reps: int) -> dict:
    """Device ms per call of the kernels `by_name` (name -> [us, calls])
    summed by the first of `groups` (name -> pattern) that matches, and
    "other"."""
    out = dict.fromkeys([*groups, "other"], 0.0)
    for name, (us, _) in by_name.items():
        key = next((g for g, pat in groups.items() if re.search(pat, name)), "other")
        out[key] += us / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default="stereodpnet_plus")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a GPU")

    config = load_config(args.model)
    pred = Predictor(config, seeded_state_dict(config), device="cuda", dtype=torch.bfloat16)
    batch = bench_batch(B, H, W)
    pred(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rate = timed(pred, [batch] * args.iters)
    print(json.dumps({"serving": rate, "model": args.model, "card": _card(), "batch": B, "hw": [H, W],
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    print(json.dumps({"stage_ms": stage_times(pred.model, lambda: pred(batch))}), flush=True)

    for line in device_profile(lambda: pred(batch), reps=2, top=args.top):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
