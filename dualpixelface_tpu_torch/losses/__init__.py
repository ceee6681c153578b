"""Loss registry (counterpart of `dualpixelface_tpu/losses/__init__.py`).

Each loss module registers itself by name with `register_loss`;
`loss_selector(option)` builds a `LossBank` that evaluates every loss in
`option.model.loss_type`, weights them by `option.model.lambdas` into
`final_loss`, and returns each as `<name>_loss`, with `abvalue` passed
through from the depth loss. Ported: `smoothL1` and `cosine`, the losses of
the stereodpnet_plus train path, `silog`, BTS's, and `folded`, the
multi-view photometric loss of dpnet's `config_multi` runs.
"""
from __future__ import annotations

from typing import Callable

_LOSS_REGISTRY: dict[str, Callable] = {}


def register_loss(name: str):
    def deco(cls):
        _LOSS_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def available_losses() -> list[str]:
    return sorted(_LOSS_REGISTRY)


class LossBank:
    """Weighted combination of the configured losses."""

    def __init__(self, option):
        names = list(option.model.loss_type)
        lambdas = list(option.model.lambdas)
        if len(names) != len(lambdas):
            raise ValueError(f"loss_type {names} and lambdas {lambdas} differ in length")
        self.target_type = option.model.get("target_type", "disp")
        self.entries = []
        for name, lam in zip(names, lambdas):
            if name not in _LOSS_REGISTRY:
                raise NotImplementedError(f"loss {name!r} not registered; have {available_losses()}")
            self.entries.append((name, lam, _LOSS_REGISTRY[name](option)))

    def __call__(self, results: dict, batch: dict) -> dict:
        out: dict = {}
        total = 0.0
        for name, lam, loss in self.entries:
            res = loss(results, batch, target_type=self.target_type)
            total = total + lam * res["loss"]
            out[f"{name}_loss"] = res["loss"]
            if "abvalue" in res:
                out["abvalue"] = res["abvalue"]
        out["final_loss"] = total
        return out


def loss_selector(option) -> LossBank:
    return LossBank(option)


# self-registration imports (keep at bottom)
from dualpixelface_tpu_torch.losses import cosine, folded, silog, smoothl1  # noqa: E402,F401
