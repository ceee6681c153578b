"""Optimizers and learning-rate schedules (counterpart of
`dualpixelface_tpu/train/optim.py`, itself the reference's
`model_selector.py:31-58`).

adam (betas 0.9 / 0.999, eps 1e-5) and sgd (momentum 0.9, weight decay
2e-4, added to the gradient before the momentum) are `torch.optim.Adam` and
`torch.optim.SGD`, which compute optax's updates. rmsprop is optax's
`rmsprop(lr)`: decay 0.9, eps 1e-8 INSIDE the square root, no momentum,
nothing centred. torch's RMSprop differs (alpha 0.99, eps outside), so it
is `OptaxRMSprop` here. Every schedule is epoch-granular: it reads
epoch = step // steps_per_epoch from the count of updates taken, which
`TrainState.apply_gradients` writes into each group's lr before the step.
"""
from __future__ import annotations

import math

import torch


def scheduler_selector(option, steps_per_epoch: int):
    """step -> learning rate: steplr (x0.5 every 35 epochs), explr (x0.5 per
    epoch), cosanneal (T_max 500 epochs down to 1e-6) or none."""
    init_lr = option.init_lr
    name = option.get("scheduler", "none")

    def epoch_of(step):
        return step // max(steps_per_epoch, 1)

    if name == "steplr":
        return lambda step: init_lr * (0.5 ** (epoch_of(step) // 35))
    if name == "explr":
        return lambda step: init_lr * (0.5 ** epoch_of(step))
    if name == "cosanneal":
        t_max, eta_min = 500, 1e-6
        return lambda step: eta_min + (init_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * (epoch_of(step) / t_max)))
    if name in ("none", None):
        return lambda step: init_lr
    raise NotImplementedError(f"scheduler {name!r}")


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay * nu + (1 - decay) * g^2 (nu starts at 0),
    p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).add_(p.grad.square(), alpha=1.0 - group["decay"])
                p.sub_(group["lr"] * p.grad / torch.sqrt(nu + group["eps"]))


def optimizer_selector(option, params, steps_per_epoch: int):
    """(optimizer over `params`, schedule) for `option.optim`."""
    schedule = scheduler_selector(option, steps_per_epoch)
    name = option.optim
    lr = schedule(0)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-5), schedule
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=2e-4), schedule
    if name == "rmsprop":
        return OptaxRMSprop(params, lr=lr), schedule
    raise NotImplementedError(f"optimizer {name!r}")
