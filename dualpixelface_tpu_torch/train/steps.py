"""Train and eval steps (counterpart of `dualpixelface_tpu/train/steps.py`).

    state = create_train_state(load_config(), steps_per_epoch)   # CUDA
    step = make_train_step(state.model, loss_selector(cfg), torch.bfloat16)
    state, losses = step(state, batch)   # losses: the `*_loss` entries

With compute_dtype bfloat16 the step follows the JAX mixed-precision
policy: f32 master parameters, a bf16 copy of the parameters and of the
batch for the forward (`torch.func.functional_call`, so the gradients reach
the f32 masters through the casts), BatchNorm statistics kept and updated in
f32, the results cast back to f32 and the losses taken on the UNCAST batch;
no loss scaling. `functional_call` runs with `tie_weights=False`: the ASM's
InstanceNorm is registered under two names (the reference's state_dict),
and swapping both names of that one module restores the bf16 copy, not
the master, when the call returns; `named_parameters()` lists it once.
The model runs in train mode (three regression heads, batch statistics).
A step's forward, loss, backward and update run one after another on the
model's device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from dualpixelface_tpu_torch.ops.precision import cast_floating


def batch_to(batch: dict, device) -> dict:
    """The array entries of `batch` (numpy or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}


def make_train_step(model, loss_bank, compute_dtype=torch.float32):
    """`train_step(state, batch, mark=None) -> (state, losses)`: one forward
    in train mode, the losses, the backward and the optimizer update of
    `state` (whose model is `model`). `mark(name)`, when given, is called at
    each phase boundary ("forward", "loss", "backward", "update", "end") for
    a profiler to time the phases."""
    bf16 = compute_dtype == torch.bfloat16

    def train_step(state, batch, mark=None):
        mark = mark or (lambda name: None)
        dev = next(model.parameters()).device
        batch = batch_to(batch, dev)
        model.train()
        mark("forward")
        if bf16:
            params = cast_floating(dict(model.named_parameters()), compute_dtype)
            results = cast_floating(functional_call(model, params, (cast_floating(batch, compute_dtype),),
                                                    tie_weights=False), torch.float32)
        else:
            results = model(batch)
        mark("loss")
        losses = loss_bank(results, batch)
        mark("backward")
        state.optimizer.zero_grad(set_to_none=True)
        losses["final_loss"].backward()
        mark("update")
        state.apply_gradients()
        mark("end")
        return state, {k: v.detach() for k, v in losses.items() if k.endswith("loss")}

    return train_step


def make_eval_step(model, compute_dtype=torch.float32):
    """`eval_step(state, batch) -> results`: the eval forward (one head,
    running statistics) with the parameters and BatchNorm statistics cast to
    `compute_dtype`, results in f32."""

    @torch.no_grad()
    def eval_step(state, batch):
        dev = next(model.parameters()).device
        model.eval()
        variables = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        results = functional_call(model, cast_floating(variables, compute_dtype),
                                  (cast_floating(batch_to(batch, dev), compute_dtype),), tie_weights=False)
        return cast_floating(results, torch.float32)

    return eval_step
