"""The tolerances of `chip_smoke.py`'s phase 11 (`DDP_TOL`) read on the card:
the run-to-run noise they must sit above, and planted faults they must
catch.

    python3 -m dualpixelface_tpu_torch.tools.ddp_tolerance

Run from the repository's root: it drives `chip_smoke.py`'s phase 10 (the
committed f32 run config, batch 4 at 768x576, Adam, 2 train steps and 2
eval batches in one process) and phase 11 (the same on 2 ranks over gloo on
the one card), and reads `chip_smoke.ddp_differences`'s four numbers (each
step's global losses, the parameters' update, the BatchNorm buffers, the
test tables) for:

  * noise: phase 10 run twice (K2's f32 atomics alone change between the
    runs), and phase 11 run twice, each against the first phase 10 run
    and against each other;
  * faults, each planted in phase 11's ranks as a patch in the process (the
    package's files untouched), read against the first phase 10 run:
      - `unsynced_bn`: BatchNorm's statistics over the rank's own rows;
      - `bn_no_grad_sum`: BatchNorm's moments summed over the ranks, but
        their gradient not (a plain all-reduce in the forward);
      - `per_rank_mean`: each rank's loss the masked mean over its own
        rows, so the gradient mean is the mean of the ranks' means.

One JSON line a reading after the card's name and power limit (faults also
say whether the ranks stayed bit for bit alike, phase 11's other check);
the last line sets the largest noise reading of each number beside the
faults' and DDP_TOL, and names the numbers each fault exceeds. Needs a GPU
and about 7 minutes on an H100.
"""
from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("unsynced_bn", "bn_no_grad_sum", "per_rank_mean")


def _smoke():
    """`chip_smoke.py`, imported from the repository's root."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def plant(fault: str) -> None:
    """Patch this process's BatchNorm or masked mean with `fault`."""
    from dualpixelface_tpu_torch import parallel
    from dualpixelface_tpu_torch.losses import common
    from dualpixelface_tpu_torch.ops import blocks

    if fault == "unsynced_bn":
        blocks.parallel = SimpleNamespace(world=parallel.world, all_reduce_sum=lambda x: x)
    elif fault == "bn_no_grad_sum":
        blocks.parallel = SimpleNamespace(world=parallel.world,
                                          all_reduce_sum=lambda x: x + (parallel.global_count(x) - x).detach())
    elif fault == "per_rank_mean":
        common.parallel = SimpleNamespace(world=parallel.world,
                                          global_count=lambda c: c.detach() * parallel.world().size)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


def faulted_rank(root: str, fault: str) -> dict:
    """A rank of phase 11 with `fault` planted."""
    plant(fault)
    return _smoke().ddp_rank(root)


def two_ranks(fn, *args) -> list:
    """Phase 11's ranks (`fn(root, *args)` each) on the one card, in a copy
    of configs/ under build/."""
    from dualpixelface_tpu_torch import parallel

    smoke = _smoke()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ddp_tolerance_", dir=ROOT / "build"))
    try:
        shutil.copytree(ROOT / "configs", tmp / "configs")
        return parallel.spawn(fn, smoke.DDP_RANKS, "cuda", args=(str(tmp), *args), cards=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    from dualpixelface_tpu_torch.ops.kernels import _build
    from dualpixelface_tpu_torch.tools import require_cuda

    require_cuda("ddp_tolerance")
    smoke = _smoke()
    card = smoke.card_line()
    print(card, flush=True)
    _build.build()  # phases 10 and 11's f32 Trainers turn TF32 off themselves

    keys = tuple(smoke.DDP_TOL)
    first = smoke.trainer_full_width(torch, card)[1]
    second = smoke.trainer_full_width(torch, card)[1]
    runs = [two_ranks(smoke.ddp_rank) for _ in range(2)]
    noise = {"phase 10 vs phase 10": smoke.ddp_differences(first, second)}
    for i, ranks in enumerate(runs):
        noise[f"phase 11 run {i} vs phase 10"] = smoke.ddp_differences(first, ranks[0])
    noise["phase 11 vs phase 11"] = smoke.ddp_differences({**runs[0][0], "init": first["init"]}, runs[1][0])
    for label, diff in noise.items():
        print(json.dumps({"noise": label, **diff, "card": card}), flush=True)

    faults = {}
    for fault in FAULTS:
        ranks = two_ranks(faulted_rank, fault)
        faults[fault] = smoke.ddp_differences(first, ranks[0])
        alike = all(r["digests"] == ranks[0]["digests"] for r in ranks)
        print(json.dumps({"fault": fault, **faults[fault], "ranks_alike": alike, "card": card}), flush=True)

    print(json.dumps({"ddp_tolerance": {
        "noise": {k: max(d[k] for d in noise.values()) for k in keys},
        "faults": {f: {k: d[k] for k in keys} for f, d in faults.items()},
        "tolerances": smoke.DDP_TOL,
        "exceeds": {f: [k for k in keys if d[k] > smoke.DDP_TOL[k]] for f, d in faults.items()},
        "card": card}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
