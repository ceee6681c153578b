"""What a traced run records, from the benchmark's side of the program:

* spans: CUDA events around every call of the window. A metric's `SPANS`
  names each span's two ends, "<module>:start" or "<module>:end" (a module
  path in the program's model, the event at its forward's start or end);
  a train step's phases come from its own `mark` argument.
* kernel sites: `record_function` ranges that hooks open and close around
  each call of a site's module (forward and, where the loop runs a
  backward, backward), named `site.<work>.<module>`, with the shapes the
  module saw, so a site keeps its meaning whatever kernel runs there. A
  metric's `SITES` lists them: {"work": <work file>, "module": <path>,
  "backward": <work file of its backward>} around a module, or {"work",
  "from": "<module>:end", "to": "<module>:start"} over the gap between two
  modules. The work file's `note(module, args, output)`, where it has one,
  says what the range's shapes are; otherwise they are the module's first
  input and its weight's output channels.
A span or site whose module the model lacks is left out, and the metric
that reads it finds nothing.
* a profiler slice: torch.profiler over a few more calls after the window;
  device busy time, host-to-device copies, each site's device time, and the
  breakdown of the slice's device time and idle gaps.
"""
from __future__ import annotations

import re
import time
from pathlib import Path

import torch

from benchmark import spec

MARKS = ("forward", "loss", "backward", "update", "end")
PROFILE_ATTEMPTS = 3
# Labels of the breakdown's device operations, each kernel in the first
# group whose pattern its name matches (profile_train.KERNEL_GROUPS).
KERNEL_GROUPS = {
    "K1-K5": r"deform_fwd_|deform_bwd_|reduce_gw_kernel|cast_depad_kernel|fsam_|conv3d_3xtf32_kernel|conv3d_tc_kernel",
    "convolutions and products": r"conv|gemm|xmma|cudnn|cutlass|fft|wgrad|dgrad|fprop|winograd|implicit|sm\d\d_",
    "optimizer": r"multi_tensor_apply",
    "reductions": r"reduce|Reduce|norm",
    "elementwise": r"elementwise|vectorized|unrolled",
    "copies": r"[Mm]emcpy|[Mm]emset",
}


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _has(model, *points) -> bool:
    try:
        for p in points:
            model.get_submodule(p.rsplit(":", 1)[0])
    except AttributeError:
        return False
    return True


def _hook(model, point: str, fn) -> list:
    """`fn(module, args, output or None)` at "<module>:start" or
    "<module>:end"; the hook's handle in a list."""
    path, at = point.rsplit(":", 1)
    mod = model.get_submodule(path)
    if at == "start":
        return [mod.register_forward_pre_hook(lambda m, args: fn(m, args, None))]
    if at == "end":
        return [mod.register_forward_hook(lambda m, args, out: fn(m, args, out))]
    raise ValueError(f"a span's end is <module>:start or <module>:end, not {point!r}")


class Spans:
    """CUDA events of every call: `begin_call()` before each call, then
    `ms()` -> {span: [ms per call]} once the card is synchronised.
    `spans`: {name: [start point, end point]}."""

    def __init__(self, model, spans: dict):
        self.calls: list[dict] = []
        hooked = {name: tuple(ends) for name, ends in spans.items() if _has(model, *ends)}
        self.handles = []
        for point in sorted({p for ends in hooked.values() for p in ends}):
            self.handles += _hook(model, point, self._at(point))
        self.pairs = dict(hooked, **{a: (a, b) for a, b in zip(MARKS, MARKS[1:])})

    def _at(self, key):
        def hook(*_):
            self.calls[-1][key] = _event()
        return hook

    def begin_call(self):
        self.calls.append({})

    def mark(self, name):
        self.calls[-1][name] = _event()

    def close(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def ms(self) -> dict:
        out = {}
        for span, (a, b) in self.pairs.items():
            vals = [c[a].elapsed_time(c[b]) for c in self.calls if a in c and b in c]
            if vals:
                out[span] = vals
        return out


def _first_input(module, args, output):
    x = args[0]
    return tuple(x.shape), x.dtype, module.weight.shape[0], 1


class Sites:
    """The ranges of a configuration's kernel sites (see the module's
    docstring). `shapes[range name]` is what the site's work count needs:
    (shape, dtype, output channels, calls a range holds)."""

    def __init__(self, model, sites: list, backward: bool, root=spec.REPO):
        self.handles, self.open, self.shapes = [], {}, {}
        for site in sites:
            if not _has(model, *(site[k] for k in ("module", "from", "to") if k in site)):
                continue
            work = site["work"]
            note = getattr(spec.module(Path(root) / "benchmark" / "work" / f"{work}.py"), "note", _first_input)
            if "module" in site:
                fwd = f"site.{work}.{site['module']}"
                names = [fwd]
                mod = model.get_submodule(site["module"])
                if backward and site.get("backward"):
                    bwd = f"site.{site['backward']}.{site['module']}"
                    names.append(bwd)
                    self.handles += [mod.register_full_backward_pre_hook(self._enter(bwd)),
                                     mod.register_full_backward_hook(self._exit(bwd))]
                self.handles += _hook(model, site["module"] + ":start", self._enter(fwd, note, names))
                self.handles += _hook(model, site["module"] + ":end", self._exit(fwd))
            else:
                name = f"site.{work}.{site['from'].rsplit(':', 1)[0]}"
                self.handles += _hook(model, site["from"], self._enter(name, note, [name]))
                self.handles += _hook(model, site["to"], self._exit(name))

    def _enter(self, name, note=None, names=()):
        def hook(module, args, *output):
            if note is not None:
                shape = note(module, args, output[0] if output else None)
                for n in names:
                    self.shapes[n] = shape
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.open[name] = rf
        return hook

    def _exit(self, name):
        def hook(*_):
            rf = self.open.pop(name, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        return hook

    def close(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def busy_us(intervals) -> float:
    """The union of (start, end) intervals: time the card was busy,
    overlapping kernels counted once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        s = max(s, end)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def _on_device(e) -> bool:
    """A kernel, copy or memset on the card; not the device-side image of a
    site range, which spans the gaps between its kernels."""
    return e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("site.")


def _device_us(e) -> float:
    return float(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0) or 0.0)


def profile_slice(call, batches) -> dict:
    """torch.profiler over one call per batch, each synchronised: the
    slice's wall and busy seconds, its host-to-device copy seconds, the
    device seconds of each call of each site range (`site.*`), the
    breakdown. A session that records no
    device activity is run again, up to PROFILE_ATTEMPTS in all; then it
    raises."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                call(batch)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = list(prof.events())
        device = [e for e in events if _on_device(e)]
        if device:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device activity in {PROFILE_ATTEMPTS} sessions")
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    sites = {}
    for e in events:
        if not _on_device(e) and e.name.startswith("site."):
            sites.setdefault(e.name, []).append(_device_us(e) / 1e6)
    return {"calls": len(batches), "wall_s": wall, "busy_s": busy_us(spans) / 1e6,
            "h2d_s": sum(e.time_range.end - e.time_range.start for e in device if "HtoD" in e.name) / 1e6,
            "sites": sites, "breakdown": breakdown(events, device)}


def _group(name: str) -> str:
    return next((g for g, pat in KERNEL_GROUPS.items() if re.search(pat, name)), "other")


def breakdown(events, device, top: int = 10) -> dict:
    """The device operations that took most of the slice (by name, summed,
    seconds) and the longest idle gaps of the card, each by the innermost
    host operation running when the gap began."""
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    ops = [[f"{_group(n)}: {n[:100]}", s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    gaps, end = [], None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in device):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    host = [e for e in events if not _on_device(e)]
    idle = []
    for length, at in sorted(gaps, reverse=True)[:top]:
        inside = [e for e in host if e.time_range.start <= at <= e.time_range.end]
        label = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name if inside else "no host op"
        idle.append([label[:100], length / 1e6])
    return {"device_ops": ops, "idle_gaps": idle}
