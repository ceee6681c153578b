"""Model registry and builder (counterpart of `dualpixelface_tpu/models/__init__.py`).

Models self-register by name. `model_selector` constructs the module on the
CPU; `build_model` is the entry point: seeded weights (a `torch.Generator`,
the reference's init) and placement on the requested device, CUDA by default.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from dualpixelface_tpu_torch import resolve_device

_MODEL_REGISTRY: dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        _MODEL_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def available_models() -> list[str]:
    _ensure_imported()
    return sorted(_MODEL_REGISTRY)


def _ensure_imported():
    from dualpixelface_tpu_torch.models.stereodpnet import mainmodel as _sdp  # noqa: F401
    from dualpixelface_tpu_torch.models.stereodpnet_plus import mainmodel as _sdpp  # noqa: F401


def model_selector(option) -> nn.Module:
    """The registered model for `option.model_name`, constructed on the CPU."""
    _ensure_imported()
    name = option.model_name
    if name not in _MODEL_REGISTRY:
        raise NotImplementedError(f"model {name!r} not registered; have {available_models()}")
    return _MODEL_REGISTRY[name](option)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic init from `seed`: convolutions He-normal with fan_out
    (the reference's normal_(0, sqrt(2/n)), n = kernel volume x out channels)
    and zero bias; norms at identity with running stats (0, 1); deformable
    convs U(+-1/sqrt(fan_in)) with their offset heads at zero."""
    from dualpixelface_tpu_torch.ops.blocks import InstanceNorm
    from dualpixelface_tpu_torch.ops.deform_conv3d import DeformConvPack3D

    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            out_ch = mod.weight.shape[1] if isinstance(mod, nn.ConvTranspose3d) else mod.weight.shape[0]
            n = math.prod(mod.weight.shape[2:]) * out_ch
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * math.sqrt(2.0 / n))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
        elif isinstance(mod, InstanceNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for mod in model.modules():
        if isinstance(mod, DeformConvPack3D):
            bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
            mod.weight.copy_((torch.rand(mod.weight.shape, generator=g) * 2 - 1) * bound)
            mod.bias.copy_((torch.rand(mod.bias.shape, generator=g) * 2 - 1) * bound)
            mod.conv_offset.weight.zero_()
            mod.conv_offset.bias.zero_()
    return model


def build_model(option, device="cuda", dtype=torch.float32, seed: int = 0) -> nn.Module:
    """Construct, seed-initialise and place the model for `option` in eval
    mode (`.train()` switches it to the train forward: three regression
    heads, batch statistics). Raises when CUDA is requested without a card."""
    dev = resolve_device(device)
    return init_weights(model_selector(option), seed).to(device=dev, dtype=dtype).eval()
