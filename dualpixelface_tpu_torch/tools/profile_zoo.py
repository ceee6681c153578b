"""Where the zoo's f32 time and memory go on the card.

    python3 -m dualpixelface_tpu_torch.tools.profile_zoo [--model psmnet] [--iters 5] [--top 12]

Run from the repository's root. For each of stereonet, psmnet, nnet, dpnet
and bts (or `--model`), at `chip_smoke.py` phase 12's cell (each model's
FaceDP run config, 768x576, f32, the seeded O(1) weights of
`chip_smoke.zoo_state_dict`, the request batches of `chip_smoke.zoo_batch`):

  * the serving forward (batch 4) and the train step (the run config's
    batch, Adam) timed through `profile_serving.timed` over `--iters`
    batches each, in turns (`SETTINGS`): at the port's exact f32
    (`ops.precision.exact_f32`, cuDNN's algorithm by its heuristics, as the
    port runs), at exact f32 with `torch.backends.cudnn.benchmark` (cuDNN
    times its algorithms per shape and takes the fastest; the port does not
    set it), and with cuDNN's TF32 allowed (torch's default);
  * at each setting: each top-level child module's device ms (CUDA events
    around its calls, summed; "outside" is the forward's rest: the volume,
    the soft-argmin, the resizes) and the most memory it held above its
    start, in one forward, and the same for the children of the model's
    `TOWER` (the cost-volume models' feature tower, BTS's decoder; dpnet's
    stages are its top-level children); at exact f32, the forward's and the
    step's busy time and top kernels by device time
    (`profile_serving.device_profile`), whose names say which algorithm
    cuDNN took.

One JSON line a reading, after the card's name and power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json

import torch

from dualpixelface_tpu_torch.tools.ddp_tolerance import _smoke

SETTINGS = ("exact_f32", "exact_f32_autotuned", "tf32", "tf32", "exact_f32_autotuned", "exact_f32")
TOWER = {"stereonet": "feature_extraction", "psmnet": "feature_extraction", "nnet": "feature_extraction",
         "bts": "decoder", "dpnet": None}


def set_precision(name: str) -> None:
    """exact_f32: the port's f32 setting; exact_f32_autotuned: the same with
    cuDNN's autotuner on; tf32: torch's defaults."""
    from dualpixelface_tpu_torch.ops.precision import exact_f32

    if name.startswith("exact_f32"):
        exact_f32()
    else:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _smoke().TORCH_TF32_DEFAULTS
    torch.backends.cudnn.benchmark = name == "exact_f32_autotuned"


def child_breakdown(model, run) -> dict:
    """Device ms and the peak GB above their start of each direct child of
    `model` over one `run()` (one forward), and the forward's rest. A
    ModuleList child, which is never called itself, counts its elements'
    calls."""
    marks, peak, base = {}, {}, {}

    def pre(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(name, []).append([ev, None])
            base[name] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return hook

    def post(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev
            peak[name] = max(peak.get(name, 0), torch.cuda.max_memory_allocated() - base[name])
        return hook

    handles = []
    for name, child in model.named_children():
        for mod in child if isinstance(child, torch.nn.ModuleList) else [child]:
            handles += [mod.register_forward_pre_hook(pre(name)), mod.register_forward_hook(post(name))]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = {name: sum(a.elapsed_time(b) for a, b in spans) for name, spans in marks.items()}
    total = start.elapsed_time(end)
    return {"forward_ms": total, "child_ms": ms, "outside_ms": total - sum(ms.values()),
            "child_peak_gb": {k: v / 1e9 for k, v in peak.items()}}


def profile_model(model: str, iters: int, top: int, card: str) -> None:
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.profile_serving import device_profile, timed
    from dualpixelface_tpu_torch.profile_train import train_batch
    from dualpixelface_tpu_torch.serve import Predictor
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step

    smoke = _smoke()
    config = smoke.zoo_option(model)
    sd = smoke.zoo_state_dict(config)
    pred = Predictor(config, state_dict=sd, device="cuda", dtype=torch.float32)
    batch = smoke.zoo_batch(model, smoke.ZOO_EVAL_BATCH, smoke.H, smoke.W)
    state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device="cuda")
    step = make_train_step(state.model, loss_selector(config), torch.float32)
    tbatch = train_batch(int(config.batch_size), smoke.H, smoke.W)
    for name in SETTINGS:
        set_precision(name)
        pred(batch)  # warm-up at this setting (cuDNN's choice, the allocator)
        step(state, tbatch)
        torch.cuda.synchronize()
        serving = timed(pred, [batch] * iters)
        train = timed(lambda b: step(state, b)[1], [tbatch] * iters)
        print(json.dumps({"model": model, "precision": name, "serving_b4": serving,
                          f"train_step_b{config.batch_size}": train, "card": card}), flush=True)

    for name in SETTINGS[:3]:
        set_precision(name)
        pred(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred(batch)
        peak = torch.cuda.max_memory_allocated() / 1e9
        tower = TOWER[model] and child_breakdown(getattr(pred.model, TOWER[model]), lambda: pred(batch))
        print(json.dumps({"model": model, "precision": name, "serving_peak_gb": peak,
                          **child_breakdown(pred.model, lambda: pred(batch)), "tower": tower,
                          "card": card}), flush=True)
    set_precision("exact_f32")
    for line in device_profile(lambda: pred(batch), reps=1, top=top):
        print(json.dumps({"model": model, "serving": line}), flush=True)
    for line in device_profile(lambda: step(state, tbatch), reps=1, top=top):
        print(json.dumps({"model": model, "train_step": line}), flush=True)


def main() -> int:
    from dualpixelface_tpu_torch.tools import require_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(TOWER), default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    require_cuda("profile_zoo")
    card = _smoke().card_line()
    print(card, flush=True)
    for model in [args.model] if args.model else list(_smoke().ZOO):
        profile_model(model, args.iters, args.top, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
