"""The port's seeded init (`models.init_weights`), on the CPU.

Every convolution, the transposed ones included, is drawn from the seed's
`torch.Generator`, by its model's rule: He-normal with fan_out unless a
model or a module declares `conv_init` (dpnet and BTS's decoder
xavier-uniform, as their JAX counterparts); the models ported before dpnet
and BTS keep their seeded state_dicts bit for bit (digests taken before
`conv_init` existed).
"""
import hashlib
import math

import pytest
import torch
from torch import nn

from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.models import build_model
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

# sha256 over the sorted names and their tensors' bytes of
# build_model(load_config(model), device="cpu", seed=s).state_dict()
DIGESTS = {
    ("stereodpnet", 0): "270e394bb151089772ff0fc19f2b1f8ceddbe5735ebf9a9f71ae44fdf53d6a26",
    ("stereodpnet", 5): "86b4e792d65b4bcd3840538afdee0b22f3e3f41c3c3bacc0207bccac9eabc15a",
    ("stereodpnet_plus", 0): "270e394bb151089772ff0fc19f2b1f8ceddbe5735ebf9a9f71ae44fdf53d6a26",
    ("stereodpnet_plus", 5): "86b4e792d65b4bcd3840538afdee0b22f3e3f41c3c3bacc0207bccac9eabc15a",
    ("stereonet", 0): "e430861b44e1e69549b0c9807f4db43373fcdaec6d314e76ae6631ae1c4510a3",
    ("stereonet", 5): "d4a3ee71a905abbc9eed4805d0dfb331d74dc622a0a82aa8e53f7b1cc9d80370",
    ("psmnet", 0): "71a2483e92387ebf0d64fb51326b9330c099b25d9be1b67b8b50e81d4363baed",
    ("psmnet", 5): "9a2816d4ae8d7c7a040041d2ac8581688d39c9e162e16d63916b6ea78e6572f3",
    ("nnet", 0): "400a6dfef55d431706a861bf3949336a885b7ccd1edebe2c93adf26032c4463e",
    ("nnet", 5): "4136d3c84948fd65704a99f57d2ec0336fea19be2e65107181b1983f90665958",
}


def digest(state_dict) -> str:
    h = hashlib.sha256()
    for name in sorted(state_dict):
        h.update(name.encode())
        h.update(state_dict[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("model,seed", sorted(DIGESTS))
def test_earlier_models_keep_their_seeded_weights(model, seed):
    assert digest(build_model(load_config(model), device="cpu", seed=seed).state_dict()) == DIGESTS[model, seed]


@pytest.mark.parametrize("model", ["dpnet", "bts"])
def test_seeded_init_is_the_seeds_alone(model):
    """Two builds from one seed are equal whatever torch's global RNG
    holds (nothing keeps torch's default init, which draws from it, the
    ConvTranspose2d of dpnet's decoders included); another seed differs."""
    config = load_config(model)
    torch.manual_seed(1)
    a = build_model(config, device="cpu", seed=3).state_dict()
    torch.manual_seed(2)
    b = build_model(config, device="cpu", seed=3).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = build_model(config, device="cpu", seed=4).state_dict()
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point() and a[k].ndim > 1)


def conv_rules(model: nn.Module) -> dict[str, str]:
    """Each conv's name -> the rule its weights fit: "xavier_uniform" when
    every entry lies within +-sqrt(6 / (fan_in + fan_out)) and the spread is
    a uniform's (std bound / sqrt(3) within 5%), "he_normal_out" when the
    std is sqrt(2 / fan_out) within 5% and some entry lies beyond 2 std
    (convs of at least 2000 entries; the rest are left out)."""
    rules = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.modules.conv._ConvNd) or mod.weight.numel() < 2000:
            continue
        w = mod.weight.detach()
        rf = math.prod(w.shape[2:])
        bound = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
        fan_out = rf * (w.shape[1] if mod.transposed else w.shape[0])
        std = float(w.std())
        if float(w.abs().max()) <= bound and abs(std / (bound / math.sqrt(3)) - 1) < 0.05:
            rules[name] = "xavier_uniform"
        elif abs(std / math.sqrt(2.0 / fan_out) - 1) < 0.05 and float(w.abs().max()) > 2 * std:
            rules[name] = "he_normal_out"
        else:
            rules[name] = "neither"
    return rules


def test_each_model_draws_its_own_rule():
    """dpnet: every conv and deconv xavier-uniform; BTS: the encoder's
    convs He-normal with fan_out, the decoder's xavier-uniform; stereonet
    (no `conv_init`): He-normal with fan_out."""
    dpnet = conv_rules(build_model(load_config("dpnet"), device="cpu"))
    assert any(".deconv.conv" in k for k in dpnet)
    assert set(dpnet.values()) == {"xavier_uniform"}, dpnet
    bts = conv_rules(build_model(load_config("bts"), device="cpu"))
    assert {v for k, v in bts.items() if k.startswith("encoder.")} == {"he_normal_out"}
    assert {v for k, v in bts.items() if k.startswith("decoder.")} == {"xavier_uniform"}
    stereonet = conv_rules(build_model(load_config("stereonet"), device="cpu"))
    assert set(stereonet.values()) == {"he_normal_out"}, stereonet
