"""Metric registry (counterpart of `dualpixelface_tpu/metrics/__init__.py`;
ref src/metric/metric_selector.py:12-40).

The reference scans src/metric/*/ and loads `<name>_Benchmark` classes from
each pack's logger.py; a MetricBank forwards every configured metric and
pretty-prints accumulated results with `viewer()`. Same contract here, with
each pack self-registering a Benchmark class via @register_metric. The
packs take the port's result dicts (torch tensors, any device and float
dtype) and batch dicts (numpy arrays or tensors) and compute on the host in
numpy, as the JAX packs do.
"""
from __future__ import annotations

from typing import Callable

_METRIC_REGISTRY: dict[str, Callable] = {}


def register_metric(name: str):
    def deco(cls):
        _METRIC_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def available_metrics() -> list[str]:
    return sorted(_METRIC_REGISTRY)


class MetricBank:
    def __init__(self, option):
        names = list(option.model.metric_type)
        self.target_type = option.model.get("target_type", "disp")
        self.benchmarks = []
        for name in names:
            if name not in _METRIC_REGISTRY:
                raise NotImplementedError(
                    f"metric {name!r} not registered; have {available_metrics()}"
                )
            self.benchmarks.append(_METRIC_REGISTRY[name](option))

    def __call__(self, results: dict, batch: dict) -> dict:
        out = {}
        for bench in self.benchmarks:
            try:
                out[bench.registry_name] = bench.measure(
                    results, batch, target_type=self.target_type
                )
            except KeyError:
                # metric inputs absent from this batch/prediction (e.g. no
                # pred_normal for a depth-only model) — skip, like the
                # reference's hasattr-style tolerance
                continue
        return out

    def viewer(self):
        for bench in self.benchmarks:
            bench.viewer()

    def aggregate(self) -> dict:
        agg = {}
        for bench in self.benchmarks:
            vals = bench.get_value()
            if vals is not None:
                agg[bench.registry_name] = dict(zip(bench.keys, vals))
        return agg

    def clear(self):
        for bench in self.benchmarks:
            bench.clear()


def metric_selector(option) -> MetricBank:
    return MetricBank(option)


from dualpixelface_tpu_torch.metrics import absolute_dp, affine_dp, normal_dp  # noqa: E402,F401
