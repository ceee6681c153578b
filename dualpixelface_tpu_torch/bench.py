"""The port's counterpart of the JAX package's `bench.py`: one JSON line
with its keys, measured on the card.

    python3 -m dualpixelface_tpu_torch.bench [--iters 20] [--hw 768x576] [--device cuda]

Four measurements at H x W (768 x 576, the reference's crop), each after a
warm-up call, each through `profile_serving.timed` (every call complete on
the card before the next), from seeded weights with non-zero offset heads:
  * `value` (`metric`): the serving forward of `stereodpnet_plus` (fast
    attention, windowed deform with the offset clamp, fused regression),
    batch 4 in bf16, --iters request batches;
  * `stereodpnet_plus_fwd_pairs_per_sec`: the same forward, measured again
    in a model of its own, as the JAX bench measures its `plus` extra;
  * `stereodpnet_exact_fwd_pairs_per_sec`: the reference-exact forward of
    `stereodpnet` (the JAX bench's `exact` mode: exact attention, unbounded
    deform, unfused regression), batch 4 in bf16;
  * `train_step_pairs_per_sec_b2`: the JAX bench's train step, the `bench`
    cell of `profile_train` (`stereodpnet`, exact attention, windowed
    deform, no offset clamp, fused regression; batch 2 under the bf16
    policy, Adam), --iters steps.
Each value is pairs over the summed latencies, unrounded. `card` is the
card's `nvidia-smi` name and power limit. There is no baseline anchor: no
number of the JAX package's TPU runs carries over. `--device cpu` runs the
same measurements on the CPU (the kernels' plain versions), for the tests
at a small `--hw`; its numbers are the CPU's (`device` says so). Without
a card and without `--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from dualpixelface_tpu_torch import resolve_device
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.ops.precision import resolve_policy
from dualpixelface_tpu_torch.profile_serving import _card, timed
from dualpixelface_tpu_torch.profile_train import cell_config, train_batch
from dualpixelface_tpu_torch.serve import Predictor, bench_batch, seeded_state_dict
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step

BATCH = 4
TRAIN_BATCH = 2


def measure_forward(model_name: str, device, h: int, w: int, iters: int) -> float:
    """Serving pairs/s of `model_name` at batch 4, bf16, over `iters`
    request batches after one warm-up batch."""
    config = load_config(model_name)
    pred = Predictor(config, seeded_state_dict(config), device=device, dtype=torch.bfloat16)
    batch = bench_batch(BATCH, h, w)
    pred(batch)
    return timed(pred, [batch] * iters)["pairs_per_s"]


def measure_train_step(device, h: int, w: int, iters: int) -> float:
    """Train pairs/s of the `bench` train cell over `iters` steps after one
    warm-up step."""
    config = cell_config("bench")
    if config.batch_size != TRAIN_BATCH:
        raise ValueError(f"the bench train cell's batch is {config.batch_size}, not {TRAIN_BATCH}")
    state = create_train_state(config, steps_per_epoch=100, state_dict=seeded_state_dict(config), device=device)
    step = make_train_step(state.model, loss_selector(config), resolve_policy(config))
    batch = train_batch(TRAIN_BATCH, h, w)
    step(state, batch)
    return timed(lambda b: step(state, b)[1], [batch] * iters)["pairs_per_s"]


def _hw(text: str) -> tuple[int, int]:
    h, _, w = text.partition("x")
    return int(h), int(w or h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hw", type=_hw, default=(768, 576), help="H x W, e.g. 768x576, or one size for both")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    h, w = args.hw

    value = measure_forward("stereodpnet_plus", device, h, w, args.iters)
    line = {
        "metric": f"stereodpnet_fwd_dp_pairs_per_sec_per_chip_{h}x{w}",
        "value": value,
        "unit": "pairs/s",
        "resolution": f"{h}x{w}",
        "batch": BATCH,
        "config": "stereodpnet_plus serving forward (fast attention, windowed deform with the offset clamp, "
                  "fused regression), bf16",
        "train_step_pairs_per_sec_b2": measure_train_step(device, h, w, args.iters),
        "stereodpnet_exact_fwd_pairs_per_sec": measure_forward("stereodpnet", device, h, w, args.iters),
        "stereodpnet_plus_fwd_pairs_per_sec": measure_forward("stereodpnet_plus", device, h, w, args.iters),
        "iters": args.iters,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": _card() if device.type == "cuda" else None,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
