"""Checkpoints of the port's trainer (counterpart of `dualpixelface_tpu/train/checkpoint.py`;
ref main.py:35-40 ModelCheckpoint(save_top_k=-1, period=1) and
src/model/model_selector.py:17-26).

A checkpoint is one `torch.save` file, `checkpoint_<epoch:02d>.pt`, written
every epoch and all kept. It holds the model's state_dict (parameters and
BatchNorm statistics), the optimizer's state_dict with the names of the
parameters it indexes, the count of steps taken and the epoch. The `.pt`
suffix keeps it apart from the JAX package's Orbax directories
(`checkpoint_<epoch:02d>/`) in a workspace both packages share.

With several ranks, rank 0 writes each file and every rank restores it.
`restore_checkpoint(path, state, strict)` loads one into a train state:
strict, every entry must be there with its shape; not strict, any entry
that is missing or whose shape differs keeps its current value, as the JAX
package's `_merge` does.
"""
from __future__ import annotations

import pickle
import zipfile
from pathlib import Path

import torch

from dualpixelface_tpu_torch import parallel
from dualpixelface_tpu_torch.utils.file_manager import error_handler

SUFFIX = ".pt"
_KEYS = ("model", "optimizer", "param_names", "step", "epoch")


def checkpoint_name(epoch: int) -> str:
    return f"checkpoint_{epoch:02d}{SUFFIX}"


def checkpoint_epoch(path) -> int:
    """The epoch of a checkpoint file, from its stem `checkpoint_<epoch>`."""
    return int(Path(path).stem.split("_")[-1])


def _param_names(model) -> list[str]:
    """The names of `model`'s parameters in the optimizer's order
    (`train/state.create_train_state` hands it `model.parameters()`)."""
    return [name for name, _ in model.named_parameters()]


def checkpoint_payload(state, epoch: int) -> dict:
    """What a checkpoint file holds (`_KEYS`) for `state` at `epoch`."""
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "param_names": _param_names(state.model), "step": int(state.step), "epoch": int(epoch)}


def save_checkpoint(ckpt_dir: str, state, epoch: int) -> str:
    """Write `checkpoint_<epoch>.pt`: rank 0 alone writes (every rank holds
    the same state), then all ranks meet at a barrier, so each finds the
    file afterwards."""
    path = (Path(ckpt_dir) / checkpoint_name(epoch)).absolute()
    if parallel.world().main:
        torch.save(checkpoint_payload(state, epoch), path)
    parallel.barrier()
    return str(path)


def load_checkpoint(path, map_location="cpu") -> dict:
    """The payload of a checkpoint file; raises if `path` is not one."""
    path = Path(path).absolute()
    error_handler(path.exists(), f"checkpoint {path} not found", __name__, True)
    if not path.is_file() or not zipfile.is_zipfile(path):
        raise RuntimeError(
            f"{path} is not a torch checkpoint of dualpixelface_tpu_torch (a {SUFFIX} file written by "
            "train/checkpoint.save_checkpoint); the JAX package's Orbax checkpoints are directories, "
            "which this package does not read")
    try:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        raise RuntimeError(f"{path} is not a torch checkpoint of dualpixelface_tpu_torch: {e}") from e
    if not (isinstance(payload, dict) and all(k in payload for k in _KEYS)):
        raise RuntimeError(f"{path} is a torch file but not a checkpoint of dualpixelface_tpu_torch "
                           f"(it lacks some of {_KEYS})")
    return payload


def _merge_model(current: dict, loaded: dict) -> dict:
    """Loaded entries where the name and shape match, current ones elsewhere."""
    return {k: loaded[k] if k in loaded and loaded[k].shape == v.shape else v for k, v in current.items()}


def _merge_optimizer(current: dict, loaded: dict, params: dict, loaded_names: list[str]) -> dict:
    """The optimizer state of each parameter of `params` (name -> tensor,
    in the optimizer's order) taken from `loaded` where the parameter of
    that name is there with its shape, the current state elsewhere; the
    hyperparameters stay the current ones."""
    by_name = {n: loaded["state"][i] for i, n in enumerate(loaded_names) if i in loaded["state"]}
    state = {}
    for i, (name, p) in enumerate(params.items()):
        new = by_name.get(name)
        if new is not None and all(not torch.is_tensor(v) or v.dim() == 0 or v.shape == p.shape
                                   for v in new.values()):
            state[i] = new
        elif i in current["state"]:
            state[i] = current["state"][i]
    return {"state": state, "param_groups": current["param_groups"]}


def restore_checkpoint(path, state, strict: bool = True):
    """Load the checkpoint at `path` into `state` (model, optimizer, step)
    and return it. strict=False keeps the current value of any entry that
    is missing or of another shape."""
    dev = next(state.model.parameters()).device
    payload = load_checkpoint(path, map_location=dev)
    if strict:
        state.model.load_state_dict(payload["model"], strict=True)
        if payload["param_names"] != _param_names(state.model):
            raise RuntimeError(f"checkpoint {path}: the optimizer indexes other parameters than the model's")
        state.optimizer.load_state_dict(payload["optimizer"])
    else:
        state.model.load_state_dict(_merge_model(state.model.state_dict(), payload["model"]), strict=True)
        state.optimizer.load_state_dict(_merge_optimizer(state.optimizer.state_dict(), payload["optimizer"],
                                                         dict(state.model.named_parameters()),
                                                         payload["param_names"]))
    state.step = int(payload["step"])
    return state
