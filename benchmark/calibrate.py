"""The readings that a cell's check limits are set from, on the card, in
one process (the benchmark's own runs never run this):

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 --controls 3 [--seconds 2] [--first-seed N]

For each seed, a run of the cell (a short window) and its check's
numbers: the program's readings. For the first `--controls` seeds also
the control and the faults that the mix's loop plants (its `controls`):
the reference, put in the program's place with its products one precision
below the configuration's (fp8 for bf16, TF32 for exact float32); serving,
each answer handed to another request of its batch; training, half of each
batch left out, the mean taken over the rest, and a step size a tenth too
large. (A train step that returns its state unchanged reads 1 on the
gradient and the change and needs no run.)
One JSON line per seed and kind, then a summary: per number the largest
program reading and the smallest control and fault readings.
"""
from __future__ import annotations

import argparse
import gc
import json

import torch

from benchmark import run, spec

LOWER = {"bf16": "fp8", "f32": "tf32"}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    run.require_cards(1)
    device = "cuda"
    seen: dict[str, dict[str, list]] = {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        res = run.measure(cell, seed, args.seconds, False, device)
        _free()
        detail = {}
        kinds = {"program": cell.loop().judge(cell, res, device, detail=detail)}
        kinds["program"]["detail"] = detail
        if i < args.controls:
            kinds.update(cell.loop().controls(cell, res, device, LOWER[cell.mix["precision"]]))
        for kind, numbers in kinds.items():
            detail = numbers.pop("detail")
            print(json.dumps({"seed": seed, "kind": kind, "numbers": numbers, "detail": detail,
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
            for k, v in numbers.items():
                seen.setdefault(kind, {}).setdefault(k, []).append(v)
        del res
        _free()
    summary = {kind: {k: (max(v) if kind == "program" else min(v)) for k, v in nums.items()}
               for kind, nums in seen.items()}
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0), "summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
