"""The training loop: one step of the program's `train.steps.make_train_step`
(the step `Trainer.fit` calls) on a batch of host arrays, complete before
the next. Set-up takes the first `check_steps` steps through the window's
own call and feed, keeping what the check compares; the window's
end-to-end metric is the pairs trained over its seconds. The check holds
those steps against the reference's (check.train_numbers)."""
from __future__ import annotations

import torch

from benchmark import check
from benchmark.system import DTYPES, program_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.ops.precision import exact_f32
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step

BACKWARD = True  # kernel sites also run their backward
# The learning-rate schedule counts epochs of this many steps: no run
# reaches one, so the rate stays at init_lr, as in a real run's first epoch.
STEPS_PER_EPOCH = 1 << 30


class Training:
    """One train step on a batch of host arrays; returns its losses. An f32
    step runs with TF32 off, as an f32 Trainer runs it."""

    def __init__(self, cell, state_dict: dict, device):
        cfg = program_config(cell)
        dtype = DTYPES[cell.mix["precision"]]
        if dtype == torch.float32:
            exact_f32()
        self.state = create_train_state(cfg, STEPS_PER_EPOCH, state_dict=state_dict, device=device)
        self.model = self.state.model
        self.step = make_train_step(self.model, loss_selector(cfg), dtype)

    def __call__(self, batch: dict, mark=None) -> dict:
        self.state, losses = self.step(self.state, batch, mark=mark)
        return losses

    def first_gradient(self) -> dict:
        """Each leaf's gradient of the first step, from Adam's first moment
        after it (m = (1 - beta1) g; zero where the step left no state)."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone() if "exp_avg" in opt.state[p]
                else torch.zeros_like(p) for n, p in self.model.named_parameters()}

    def parameters(self) -> dict:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}


def build(cell, state_dict: dict, device):
    return Training(cell, state_dict, device)


def set_up(sut, call, pool: list, mix: dict, state_dict: dict, sync) -> dict:
    """The checked first steps, through the window's own call and feed."""
    losses = []
    for i in range(mix["check_steps"]):
        losses.append(float(call(pool[i])["final_loss"]))
        if i == 0:
            grads = sut.first_gradient()
    after = sut.parameters()
    return {"losses": losses, "grads": grads, "change": {k: v - state_dict[k] for k, v in after.items()}}


def end_to_end(calls: int, latencies_s: list, window_s: float, mix: dict) -> dict:
    return {"train_pairs_per_s": (calls * mix["batch"] / window_s, "pairs/s")}


def judge(cell, res: dict, device, detail=None) -> dict:
    """The program's checked steps against the reference's."""
    batches = res["pool"][:cell.mix["check_steps"]]
    return check.train_numbers(res["steps"], check.train_reference(cell, res["state_dict"], batches, device), detail)


def controls(cell, res: dict, device, lower: str) -> dict:
    """{kind: numbers}: the control (the reference with its products at
    `lower`, in the program's place), half of each batch left out, and a
    step size a tenth too large. (A step that returns its state unchanged
    reads 1 on the gradient and the change and needs no run.)"""
    batches = res["pool"][:cell.mix["check_steps"]]
    want = check.train_reference(cell, res["state_dict"], batches, device)
    out = {}
    for kind, kw in (("control", {"precision": lower}), ("half_batch", {"half_batch": True}),
                     ("lr_x1.1", {"lr_scale": 1.1})):
        detail = {}
        out[kind] = check.train_numbers(check.train_reference(cell, res["state_dict"], batches, device, **kw), want,
                                        detail)
        out[kind]["detail"] = detail
    return out


def flops(ref, model: dict, batch: dict) -> None:
    """The call whose products a FLOP counter counts: the forward in train
    mode, the losses and the backward."""
    net = ref.build(model, chunk=1 << 40).train(True)
    ref.losses(model, net(batch), batch)["final_loss"].backward()
