"""Tiny fixed-width table printer (a copy of `dualpixelface_tpu/utils/table.py`).

Replaces the reference's `texttable` dependency used by the metric benchmark
viewers (ref src/metric/*/logger.py, metric_selector.py:35-40) with a
zero-dependency equivalent.
"""
from __future__ import annotations

from typing import Iterable, Sequence


class Table:
    def __init__(self, col_width: int = 12):
        self.col_width = col_width
        self.rows: list[Sequence] = []
        self.header: Sequence | None = None

    def set_header(self, header: Sequence):
        self.header = list(header)
        return self

    def add_row(self, row: Iterable):
        self.rows.append(list(row))
        return self

    def _fmt(self, v) -> str:
        if isinstance(v, float):
            s = f"{v:.6f}"
        else:
            s = str(v)
        return s.rjust(self.col_width)[: self.col_width * 2]

    def draw(self) -> str:
        lines = []
        if self.header is not None:
            lines.append(" ".join(self._fmt(h) for h in self.header))
            lines.append("=" * ((self.col_width + 1) * len(self.header) - 1))
        for row in self.rows:
            lines.append(" ".join(self._fmt(v) for v in row))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.draw()
