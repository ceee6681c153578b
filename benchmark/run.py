"""One run of one benchmark cell, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the weights (the configuration's reference module's init) and the
traffic from the seed, builds the program's entry point for the cell by
the mix's loop (`benchmark/loops/<loop>.py`), sets up (the loop's warm-up
calls, or a train cell's first, checked steps), then drives it in a
closed loop, one caller, each call complete on the card before the next,
for `--seconds`. `--trace 0` prints the cell's end-to-end metrics (the
loop's); `--trace 1` records spans over the window and a profiler slice
after it, and prints the per-layer metrics. Either way, once the window
has closed and the program is freed, the plain reference judges what the
timed path produced (the loop's `judge`, check.py). The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device [, breakdown], checks.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result. It also exits 2, after the window, if the process
has loaded JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark import check, generate, spec, trace
from benchmark.reading import Reading
from benchmark.work.flops import step_flops

_IMPORTED = time.perf_counter()
# Top-level module names a run may not load, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dualpixelface_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Refused(SystemExit):
    """A run that prints no result."""


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise Refused(f"benchmark: the cell needs {chips} CUDA card(s); this machine has {n}")


def peak_bytes(cuda: bool) -> int:
    """The allocator's peak on the fullest card this process uses."""
    return max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())) if cuda else 0


def reset_peaks(cuda: bool) -> None:
    for i in range(torch.cuda.device_count() if cuda else 0):
        torch.cuda.reset_peak_memory_stats(i)


def device_info(device, peak: int, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": peak}


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda", fault=None) -> dict:
    """One run; returns the result's fields and what the check needs.
    `fault(system) -> call` replaces the timed call (the tests' planted
    faults)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mix, loop, ref = cell.mix, cell.loop(), cell.reference()

    with torch.device("meta"):
        shapes = ref.build(cell.config["model"])
    state_dict = ref.init_state_dict(shapes, generate.substream(seed, 0), device)
    pool = generate.pool(mix, seed, device)
    sut = loop.build(cell, state_dict, device)
    call = sut if fault is None else fault(sut)
    steps = loop.set_up(sut, call, pool, mix, state_dict, sync)
    sync()
    setup_s = process_seconds()

    peak = peak_bytes(cuda)
    reset_peaks(cuda)
    rng = np.random.default_rng(generate.substream(seed, 2))
    sample = set(rng.choice(len(pool), size=min(mix.get("check_batches", 0), len(pool)), replace=False).tolist())
    spans, sites_wanted = None, []
    if traced:  # the spans and kernel sites the cell's per-layer metrics read
        hooks = [spec.metric(m["name"], cell.root) for m in cell.per_layer]
        spans = trace.Spans(sut.model, {k: v for h in hooks for k, v in getattr(h, "SPANS", {}).items()})
        for site in (s for h in hooks for s in getattr(h, "SITES", [])):
            if site not in sites_wanted:
                sites_wanted.append(site)
    kept, lat, n = {}, [], 0
    t_start = t_end = time.perf_counter()
    while t_end - t_start < seconds:
        i = n % len(pool)
        if spans:
            spans.begin_call()
        t0 = time.perf_counter()
        out = call(pool[i], mark=spans.mark if spans else None)
        sync()
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        n += 1
        if i in sample:
            kept[i] = out
    window_s = t_end - t_start
    res = {"attempted": n, "failed": 0}
    if not traced:
        metrics = {"setup_s": (setup_s, "s")}
        metrics.update(loop.end_to_end(n, lat, window_s, mix))
    else:
        spans.close()
        sync()
        span_ms = spans.ms()
        window_peak = peak_bytes(cuda)
        sites = trace.Sites(sut.model, sites_wanted, loop.BACKWARD, cell.root)
        try:
            sliced = trace.profile_slice(call, [pool[(n + j) % len(pool)] for j in range(mix["profile_calls"])])
        finally:
            sites.close()
        reading = Reading(cell=cell, calls=n, window_s=window_s, spans=span_ms, slice=sliced,
                          site_shapes=sites.shapes, flops_per_call=step_flops(cell), window_peak_bytes=window_peak)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"], cell.root)(reading)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        res["breakdown"] = sliced["breakdown"]
        res["busy_s"], res["window_s"] = sliced["busy_s"], sliced["wall_s"]
    peak = max(peak, peak_bytes(cuda))
    res["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()}
    res["device"] = device_info(device, peak, cell.chips)
    if traced:
        res["device"].update(busy_s=res.pop("busy_s"), window_s=res.pop("window_s"))
    res["kept"] = [(pool[i], out) for i, out in sorted(kept.items())]
    res["steps"], res["pool"], res["state_dict"] = steps, pool, state_dict
    return res


def run(argv=None, *, root=spec.REPO, device="cuda", look_for_card=True, fault=None) -> tuple[dict, dict]:
    """(the result line, the check's numbers beside their limits)."""
    args = parse(argv)
    cell = spec.cell(args.workload, root)
    if look_for_card:
        require_cards(cell.chips)
    res = measure(cell, args.seed, args.seconds, bool(args.trace), device, fault)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.loop().judge(cell, res, device)
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    line = {"correct": check.judge(numbers, limits), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    return line, checks


def main(argv=None) -> int:
    try:
        line, checks = run(argv)
    except Refused as e:
        print(e, file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; the program under test may not", file=sys.stderr)
        return 2
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
