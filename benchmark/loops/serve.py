"""The serving loop: one request batch of host arrays through the
program's `serve.Predictor.__call__`, complete on the card before the
next. Set-up warms the shapes up with two batches; the window's
end-to-end metrics are the pairs answered over its seconds and the 95th
percentile of the batches' latencies, named by the mix. The check
compares the last answer the window gave to each of `check_batches`
batches drawn from the seed with the reference's (check.serve_numbers)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import check
from benchmark.system import DTYPES, program_config
from dualpixelface_tpu_torch.serve import Predictor

BACKWARD = False  # no kernel site runs a backward


class Serving:
    def __init__(self, cell, state_dict: dict, device):
        self.predictor = Predictor(program_config(cell), state_dict, device=device, dtype=DTYPES[cell.mix["precision"]])
        self.model = self.predictor.model

    def __call__(self, batch: dict, mark=None) -> dict:
        return self.predictor(batch)


def build(cell, state_dict: dict, device):
    return Serving(cell, state_dict, device)


def set_up(sut, call, pool: list, mix: dict, state_dict: dict, sync) -> dict:
    for batch in pool[:2]:
        call(batch)
        sync()
    return {}


def end_to_end(calls: int, latencies_s: list, window_s: float, mix: dict) -> dict:
    """The pairs answered over the window's seconds and the 95th percentile
    of the batches' latencies, under the names the mix gives them
    (`end_to_end`: {"rate": ..., "p95": ...})."""
    names = mix["end_to_end"]
    return {names["rate"]: (calls * mix["batch"] / window_s, "pairs/s"),
            names["p95"]: (float(np.percentile(np.asarray(latencies_s) * 1e3, 95)), "ms")}


def judge(cell, res: dict, device, detail=None) -> dict:
    return check.serve_numbers(cell, res["state_dict"], res["kept"], device, detail=detail)


def tile_swapped(out: dict, hw: tuple, share: float = 0.005) -> dict:
    """The answer with a square tile of about `share` of the first
    sample's pixels taken from the second sample's, in every output laid
    out [B, n, H, W, ...]: a fault confined to a small part of one
    answer."""
    out = dict(out)
    h, w = hw
    side = max(1, round((share * h * w) ** 0.5))
    y, x = h // 3, w // 3
    for key, v in out.items():
        if v is not None and v.dim() >= 4 and tuple(v.shape[2:4]) == (h, w) and v.shape[0] > 1:
            v = v.clone()
            v[0, :, y:y + side, x:x + side] = v[1, :, y:y + side, x:x + side]
            out[key] = v
    return out


def controls(cell, res: dict, device, lower: str) -> dict:
    """{kind: numbers}: the control (the reference with its products at
    `lower`, in the program's place), an answer handed to another request
    of its batch, and a tile of one answer taken from another's."""
    ref = cell.reference()
    net = check.reference_model(cell, res["state_dict"], device, lower)
    lowered, swapped, tiled = [], [], []
    with torch.no_grad():
        for batch, got in res["kept"]:
            lowered.append((batch, ref.answer(net, {k: torch.as_tensor(v, device=device).float()
                                                    for k, v in batch.items()})))
            swapped.append((batch, {k: None if v is None else v.roll(1, 0) for k, v in got.items()}))
            tiled.append((batch, tile_swapped(got, batch["left"].shape[1:3])))
    del net
    out = {}
    for kind, kept in (("control", lowered), ("answers_swapped", swapped), ("tile_swapped", tiled)):
        detail = {}
        out[kind] = check.serve_numbers(cell, res["state_dict"], kept, device, detail=detail)
        out[kind]["detail"] = detail
    return out


def flops(ref, model: dict, batch: dict) -> None:
    """The call whose products a FLOP counter counts: the forward."""
    with torch.no_grad():
        ref.build(model, chunk=1 << 40).eval()(batch)  # one block: fewer meta calls
