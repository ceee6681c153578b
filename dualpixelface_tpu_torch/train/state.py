"""Train state (counterpart of `dualpixelface_tpu/train/state.py`): the
model (f32 master parameters and BatchNorm statistics), its optimizer and
learning-rate schedule, and the count of steps taken."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from dualpixelface_tpu_torch import parallel, resolve_device
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.train.optim import optimizer_selector
from dualpixelface_tpu_torch.weights import load_state_dict


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' .grad, at the
        schedule's rate for the current step."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(option, steps_per_epoch: int, state_dict=None, device="cuda", seed: int = 0) -> TrainState:
    """The model for `option` in train mode and f32 on `device` (CUDA unless
    the caller asks for the CPU; without a card it raises; this rank's card
    when several ranks train), with the seeded init or `state_dict`
    (reference-named, e.g. `weights.state_dict_from_jax`), and the
    optimizer and schedule of `option.optim` / `option.scheduler`. Every
    rank must start from the same weights: a digest all-reduce checks it
    (nothing is broadcast over a difference)."""
    dev = resolve_device(device)
    model = build_model(option, device="cpu", seed=seed)
    if state_dict is not None:
        load_state_dict(model, state_dict)
    model = model.to(dev).train()
    parallel.check_replicated(model, "the initial weights")
    optimizer, schedule = optimizer_selector(option, list(model.parameters()), steps_per_epoch)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)



def param_count(state: TrainState) -> int:
    """The number of the model's parameters, as the JAX package counts its
    params tree (BatchNorm statistics and other buffers left out; a module
    registered under two names, the ASM's InstanceNorm, counted once)."""
    return sum(p.numel() for p in state.model.parameters())
