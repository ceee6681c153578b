"""What a traced run read, as the per-layer metrics' readers see it. Each
reader (`benchmark/metrics/<metric>.py`) takes one `Reading` and returns a
number, or None where it finds nothing to read."""
from __future__ import annotations

import statistics
from dataclasses import dataclass

from benchmark import peaks, spec

ITEMSIZE = {"bf16": 2, "f32": 4}


@dataclass
class Reading:
    cell: spec.Cell
    calls: int             # calls in the window
    window_s: float        # the window's seconds
    spans: dict            # span -> [device ms of each call]
    slice: dict            # trace.profile_slice's result
    site_shapes: dict      # site range -> (input shape, dtype, output channels, calls a range holds)
    flops_per_call: float  # products' FLOPs of one call (work/flops.py)
    window_peak_bytes: int

    @property
    def precision(self) -> str:
        return self.cell.mix["precision"]

    def span_ms(self, name: str) -> float | None:
        vals = self.spans.get(name)
        return statistics.fmean(vals) if vals else None

    def slice_ms_per_call(self, key: str) -> float | None:
        s = self.slice
        return s[key] / s["calls"] * 1e3 if s and s["calls"] else None

    def idle_percent(self) -> float | None:
        s = self.slice
        return 100.0 * (1.0 - s["busy_s"] / s["wall_s"]) if s and s["wall_s"] > 0 else None

    def peak_gb(self) -> float:
        return self.window_peak_bytes / 1e9

    def mfu_percent(self) -> float | None:
        if not self.window_s or not self.flops_per_call:
            return None
        return 100.0 * self.flops_per_call * self.calls / self.window_s / peaks.PRODUCTS[self.precision]

    def roofline_percent(self, kinds: tuple) -> float | None:
        """Over the slice's calls of the sites of `kinds`: the sum of each
        call's least time over the sum of its device time. A call the
        profiler gave no device time is left out of both sums."""
        least = device = 0.0
        image = (self.cell.mix["height"], self.cell.mix["width"])
        for name, seconds in self.slice.get("sites", {}).items():
            kind = name.split(".")[1]
            if kind not in kinds or name not in self.site_shapes:
                continue
            shape, _, co, calls = self.site_shapes[name]
            parts = spec.site_work(kind, self.cell.root)(shape, ITEMSIZE[self.precision], co, image)
            for s in seconds:
                if s > 0:
                    least += calls * peaks.least_seconds(parts, self.precision)
                    device += s
        return 100.0 * least / device if device > 0 else None
