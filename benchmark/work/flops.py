"""FLOPs of the products (convolutions and matrix products) of one call
of a cell: the loop's call (`flops` of benchmark/loops/<loop>.py) at the
mix's shapes, over the cell's plain reference on the meta device, counted
by `torch.utils.flop_counter.FlopCounterMode`, so the count is the same
whatever runs the call."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import generate


def step_flops(cell) -> float:
    with torch.device("meta"):
        batch = {k: torch.empty(shape) for k, shape in generate.shapes(cell.mix).items()}
        counter = FlopCounterMode(display=False)
        with counter:
            cell.loop().flops(cell.reference(), cell.config["model"], batch)
    return float(counter.get_total_flops())
