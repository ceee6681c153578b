"""Dataset loader registry (counterpart of `dualpixelface_tpu/data/loader_selector.py`;
ref dataloader/loader_selector.py:8-16).

Datasets self-register by name; `loader_selector(option, training)`
resolves `option.dataset_name`. Only the selected dataset's module is
imported, so the SyntheticDP path never imports the FaceDP reader (and
with it PIL).
"""
from __future__ import annotations

import importlib

_LOADER_REGISTRY: dict[str, type] = {}
_LOADER_MODULES = {
    "FaceDP": "dualpixelface_tpu_torch.data.FaceDP.loader",
    "SyntheticDP": "dualpixelface_tpu_torch.data.SyntheticDP.loader",
}


def register_loader(name: str):
    def deco(cls):
        _LOADER_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def available_loaders() -> list[str]:
    return sorted(set(_LOADER_REGISTRY) | set(_LOADER_MODULES))


def loader_selector(option, training: bool):
    name = option.dataset_name
    if name not in _LOADER_REGISTRY and name in _LOADER_MODULES:
        importlib.import_module(_LOADER_MODULES[name])
    if name not in _LOADER_REGISTRY:
        raise NotImplementedError(f"dataset {name!r} not registered; have {available_loaders()}")
    return _LOADER_REGISTRY[name](option, training)
