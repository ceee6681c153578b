"""Model configuration for the PyTorch port (merge only).

Counterpart of `dualpixelface_tpu/config/manager.py`: the model layer
(`models/<model_name>/config.json`, a copy carried by this package)
and the dataset keys the models read are merged into one attribute-access
tree. The port runs no trainer yet, so there is no run config, workspace or
augmentation layer.
"""
from __future__ import annotations

import json
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent

# The only dataset keys a model reads (models/base.py select_ref_target in
# the JAX package); the values of the SyntheticDP dataset config.
DATASET_DEFAULTS = {"flip_lr": False}


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
) -> Config:
    """Merge the packaged model config (`models/<model_name>/config.json`)
    and the dataset keys into one tree: `cfg.model_name`, `cfg.model.<key>`,
    `cfg.dataset.<key>`."""
    path = PACKAGE_ROOT / "models" / model_name / "config.json"
    if not path.is_file():
        raise FileNotFoundError(f"no model config {path}")
    with open(path) as f:
        model = json.load(f)
    model.update(model_overrides or {})
    dataset = dict(DATASET_DEFAULTS)
    dataset.update(dataset_overrides or {})
    return Config({"model_name": model_name, "model": model, "dataset": dataset})
