"""Configuration of the PyTorch port (merge only).

Counterpart of `dualpixelface_tpu/config/manager.py`: the model layer
(`models/<model_name>/config.json`, a copy carried by this package), the
run keys the train step reads and the dataset keys the models and losses
read are merged into one attribute-access tree. The port has no trainer
loop yet, so there is no workspace or augmentation layer.
"""
from __future__ import annotations

import json
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent

# The dataset keys the models and losses read (select_ref_target,
# prepare_disparity_gt); the values of the JAX package's SyntheticDP dataset
# config (dualpixelface_tpu/data/SyntheticDP/config.json).
DATASET_DEFAULTS = {"flip_lr": False, "dp_conversion": "given"}

# The run keys the train step reads; the values of the JAX package's
# configs/train_synthetic_stereodpnet_plus.json.
RUN_DEFAULTS = {"optim": "adam", "init_lr": 1e-4, "scheduler": "steplr", "precision": 32, "batch_size": 8}


class Config:
    """Recursive attribute-access wrapper over a dict, with `.get`."""

    def __init__(self, d: dict):
        for key, value in d.items():
            setattr(self, key, Config(value) if isinstance(value, dict) else value)

    def get(self, key, default=None):
        return getattr(self, key, default)


def load_config(
    model_name: str = "stereodpnet_plus",
    model_overrides: dict | None = None,
    dataset_overrides: dict | None = None,
    run_overrides: dict | None = None,
) -> Config:
    """Merge the packaged model config (`models/<model_name>/config.json`),
    the run keys and the dataset keys into one tree: `cfg.model_name`,
    `cfg.<run key>`, `cfg.model.<key>`, `cfg.dataset.<key>`."""
    path = PACKAGE_ROOT / "models" / model_name / "config.json"
    if not path.is_file():
        raise FileNotFoundError(f"no model config {path}")
    with open(path) as f:
        model = json.load(f)
    model.update(model_overrides or {})
    dataset = dict(DATASET_DEFAULTS)
    dataset.update(dataset_overrides or {})
    run = dict(RUN_DEFAULTS)
    run.update(run_overrides or {})
    return Config({**run, "model_name": model_name, "model": model, "dataset": dataset})
