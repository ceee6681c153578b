"""Benchmark accumulator base (counterpart of `dualpixelface_tpu/metrics/base.py`;
ref src/metric/*/logger.py pattern):
per-batch values appended, mean on get_value, table print in viewer."""
from __future__ import annotations

import numpy as np

from dualpixelface_tpu_torch.utils.table import Table


class Benchmark:
    keys: tuple[str, ...] = ()

    def __init__(self, option, samplenum: int = -1):
        self.opt = option
        self.samplenum = samplenum
        self.index = 0
        self.metric = {k: [] for k in self.keys}

    def measure(self, results: dict, batch: dict, log: bool = True):
        raise NotImplementedError

    def update(self, data):
        if self.samplenum != -1 and self.index >= self.samplenum:
            return
        assert len(data) == len(self.keys)
        for k, v in zip(self.keys, data):
            self.metric[k].append(float(v))
        self.index += 1

    def get_value(self, pos: int = -1):
        if self.index == 0:
            return None
        if pos == -1:
            return [float(np.mean(self.metric[k])) for k in self.keys]
        return [self.metric[k][pos] for k in self.keys]

    def viewer(self):
        vals = self.get_value()
        if vals is None:
            print(f"[{type(self).__name__}] no data stored")
            return
        t = Table().set_header(self.keys).add_row(vals)
        print(f"== {type(self).__name__} ({self.index} samples) ==")
        print(t.draw())

    def clear(self):
        self.metric = {k: [] for k in self.keys}
        self.index = 0
