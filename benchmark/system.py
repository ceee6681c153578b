"""The program's side, shared by the loops (`benchmark/loops/`), which
build the system under test through the program's own entry points; the
loops and this module are the only ones of the benchmark that import the
program."""
from __future__ import annotations

import torch

from dualpixelface_tpu_torch.config import load_config

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def program_config(cell):
    """The program's merged config: the configuration file's model keys and
    the mix's run keys."""
    mix = cell.mix
    run = {"batch_size": mix["batch"], "precision": "bf16" if mix["precision"] == "bf16" else 32}
    run.update({k: mix[k] for k in ("optim", "init_lr", "scheduler") if k in mix})
    return load_config(cell.config["model_name"], model_overrides=cell.config["model"], run_overrides=run)
