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
    from dualpixelface_tpu_torch.models.bts import mainmodel as _bts  # noqa: F401
    from dualpixelface_tpu_torch.models.dpnet import mainmodel as _dpnet  # noqa: F401
    from dualpixelface_tpu_torch.models.nnet import mainmodel as _nnet  # noqa: F401
    from dualpixelface_tpu_torch.models.psmnet import mainmodel as _psm  # noqa: F401
    from dualpixelface_tpu_torch.models.stereodpnet import mainmodel as _sdp  # noqa: F401
    from dualpixelface_tpu_torch.models.stereodpnet_plus import mainmodel as _sdpp  # noqa: F401
    from dualpixelface_tpu_torch.models.stereonet import mainmodel as _sn  # noqa: F401


def model_selector(option) -> nn.Module:
    """The registered model for `option.model_name`, constructed on the CPU."""
    _ensure_imported()
    name = option.model_name
    if name not in _MODEL_REGISTRY:
        raise NotImplementedError(f"model {name!r} not registered; have {available_models()}")
    return _MODEL_REGISTRY[name](option)


def _modules_with_init(model: nn.Module):
    """(module, conv init) for every module of `model` in `model.modules()`
    order (each shared module once), the init the innermost module that
    declares `conv_init` names, itself included: "he_normal_out" unless a
    model says otherwise."""
    seen = set()

    def walk(mod, init):
        if id(mod) in seen:
            return
        seen.add(id(mod))
        init = getattr(mod, "conv_init", init)
        yield mod, init
        for child in mod.children():
            yield from walk(child, init)

    yield from walk(model, "he_normal_out")


def _conv_weight(w: torch.Tensor, init: str, transposed: bool, g: torch.Generator) -> torch.Tensor:
    """he_normal_out: N(0, 2 / n), n = kernel volume x out channels (the
    reference's normal_(0, sqrt(2/n)); a transposed conv's out channels are
    its weight's dim 1). xavier_uniform: U(+-sqrt(6 / (fan_in + fan_out))),
    Flax's `xavier_uniform` and torch's, which agree for every layout
    (grouped and transposed too) as they add the two fans."""
    rf = math.prod(w.shape[2:])
    if init == "he_normal_out":
        n = rf * (w.shape[1] if transposed else w.shape[0])
        return torch.randn(w.shape, generator=g) * math.sqrt(2.0 / n)
    if init == "xavier_uniform":
        bound = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
        return (torch.rand(w.shape, generator=g) * 2 - 1) * bound
    raise ValueError(f"conv init {init!r}")


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic init from `seed`: every convolution (2-D, 3-D,
    transposed or not) by its model's `conv_init` (He-normal with fan_out,
    the reference's, unless a model or one of its modules declares
    "xavier_uniform", as dpnet and BTS's decoder do in JAX) and zero bias;
    norms at identity with running stats (0, 1); deformable convs
    U(+-1/sqrt(fan_in)) with their offset heads at zero. The draws follow
    `model.modules()` order."""
    from dualpixelface_tpu_torch.ops.blocks import InstanceNorm
    from dualpixelface_tpu_torch.ops.deform_conv3d import DeformConvPack3D

    g = torch.Generator().manual_seed(seed)
    for mod, conv_init in _modules_with_init(model):
        if isinstance(mod, nn.modules.conv._ConvNd):
            mod.weight.copy_(_conv_weight(mod.weight, conv_init, mod.transposed, g))
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
