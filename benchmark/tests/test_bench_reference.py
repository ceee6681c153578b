"""The frozen reference against the port's CPU path at a small size, on
one state_dict: the same names, the same outputs, the same first loss."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import check, generate, spec
from benchmark.reference import stereodpnet as ref
from benchmark.tests.conftest import REPO

CONFIGS = ("stereodpnet", "stereodpnet_plus")


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def _state(config, seed=11):
    with torch.device("meta"):
        shapes = ref.StereoDPNet(config["model"])
    return ref.init_state_dict(shapes, seed, "cpu")


def _reference(config, state_dict, train=False):
    net = ref.build(config["model"])
    net.load_state_dict(state_dict)
    return net.train(train)


def _port(config, state_dict, train=False):
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.models import build_model

    cfg = load_config(config["model_name"], model_overrides=config["model"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.train(train), cfg


def _batch(b=2, h=64, w=48, train=False):
    mix = json.loads((REPO / "benchmark/traffic/train.f32.b4.json").read_text())
    mix.update(batch=b, height=h, width=w, pool=1)
    if not train:
        del mix["labels"]
    return {k: torch.as_tensor(v) for k, v in generate.pool(mix, 5, "cpu")[0].items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_names_and_shapes_are_the_programs(name):
    config = _config(name)
    sd = _state(config)
    port, _ = _port(config, sd)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_outputs_agree_with_the_port(name):
    config = _config(name)
    sd = _state(config)
    port, _ = _port(config, sd)
    net = _reference(config, sd)
    batch = _batch()
    with torch.no_grad():
        got, want = port(batch), net(batch)
    for key in ("pred_depth", "pred_normal", "prob_depth"):
        if want[key] is None:
            assert got[key] is None
            continue
        assert check.gap_quantile(got[key], want[key]) < 1e-4  # f32 through other library calls: 2e-5 read
        scale = want[key].abs().max()
        assert (got[key] - want[key]).abs().max() <= 1e-4 * scale


def test_first_train_loss_agrees_with_the_port():
    from dualpixelface_tpu_torch.losses import loss_selector

    config = _config("stereodpnet")
    sd = _state(config)
    port, cfg = _port(config, sd, train=True)
    net = _reference(config, sd, train=True)
    batch = _batch(train=True)
    got = loss_selector(cfg)(port(batch), batch)
    want = ref.losses(config["model"], net(batch), batch)
    for k in ("smoothL1_loss", "cosine_loss", "final_loss"):
        assert abs(float(got[k].detach()) - float(want[k].detach())) <= 1e-5 * abs(float(want[k].detach()))


def test_init_is_seeded_and_offsets_leave_the_grid():
    config = _config("stereodpnet_plus")
    a, b, c = _state(config, 1), _state(config, 1), _state(config, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["feature_extraction.firstconv.0.0.weight"], c["feature_extraction.firstconv.0.0.weight"])
    assert 0.1 < a["normal_estimator.deform_conv1.conv_offset.bias"].abs().mean() < 0.4
    assert float(a["feature_extraction.block1.prelu.weight"]) == pytest.approx(0.05)


def test_tf32_and_fp8_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -12), 3.0])
    assert ref.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 3.0]
    y = torch.linspace(-3, 3, 101)
    e = (ref.round_fp8(y) - y).abs().max()
    assert 0 < e <= 3 * 2 ** -4


def test_window_and_disparity_planes():
    net = ref.StereoDPNet(_config("stereodpnet")["model"])
    assert net.deltas == [-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5]
    assert list(net.bins[:3]) == [-4.0, -3.5, -3.0] and len(net.bins) == 32
    assert spec.cell("stereodpnet.serve.f32.b4").config["model"]["deform_impl"] == "packed8"
