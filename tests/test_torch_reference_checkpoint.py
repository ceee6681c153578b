"""The port's reference-checkpoint bridges against the JAX package's tools,
on the CPU.

Weights: the JAX `stereodpnet` tree of the committed eval config
`eval_synthetic_stereodpnet` (its shapes by `jax.eval_shape`, its values
refilled from a seed by `torch_zoo.fill`, so no JAX forward runs), with
`use_deform` on and off. The JAX exporter
(`tools/export_stereodpnet_checkpoint.py`) writes it in the reference's
format, to which the reference-only buffers are added (`costrange`,
`grid`, a `regression_layer` key, real BatchNorm counts); that payload is
saved bare, under `state_dict` and under `model`.

- The port's converter gives, tensor for tensor and in the same order,
  `weights.state_dict_from_jax` of the JAX converter's tree, but for the
  BatchNorm counts, which it keeps (JAX has none); both leave no key over.
- A foreign key makes the converter's CLI raise, as does an ASM
  InstanceNorm whose two names differ.
- The port's exporter writes the JAX exporter's keys and values for the
  same weights, and the JAX converter of its output gives back the JAX tree.
- `asm_activation: "relu"`: the converter writes the ASM PReLU's init
  slope, the exporter leaves it out, as the JAX pair does.
- Both CLIs run once in a subprocess: the converted `.pt` restores under
  `load_strict: true` into the eval config's train state, and its export
  gives back the reference payload with the counts.
- `train/state.param_count` equals the JAX package's.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as zoo
from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu.train.state import param_count as jax_param_count
from dualpixelface_tpu_torch.config import Configuration, load_config
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.tools import convert_stereodpnet_checkpoint as convert
from dualpixelface_tpu_torch.tools.export_stereodpnet_checkpoint import block_stack_of, export_stereodpnet_state_dict
from dualpixelface_tpu_torch.train.checkpoint import restore_checkpoint
from dualpixelface_tpu_torch.train.state import create_train_state, param_count
from dualpixelface_tpu_torch.weights import load_state_dict, state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_stereodpnet_checkpoint import convert_stereodpnet_state_dict as jax_convert  # noqa: E402
from export_stereodpnet_checkpoint import export_stereodpnet_state_dict as jax_export  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CONFIG = "eval_synthetic_stereodpnet"
REFERENCE_ONLY = ("cost_volume.costrange", "normal_estimator.grid", "regression_layer.disp_values")


@pytest.fixture(scope="module")
def jax_trees():
    """{use_deform: (params, batch_stats, the JAX config's param shapes)}."""
    batch = jax.tree_util.tree_map(jnp.asarray, _tiny_batch(1, 32, 32))
    trees = {}
    for use_deform in (True, False):
        cfg = JaxConfiguration(RUN_CONFIG, make_workspace=False)
        cfg.data["model"]["use_deform"] = use_deform
        model = jax_model_selector(cfg.get_config())
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, train=False))
        v = zoo.fill(shapes, np.random.default_rng(7 + use_deform))
        trees[use_deform] = (v["params"], v["batch_stats"], shapes["params"])
    return trees


def _reference_payload(params, stats, seed=0) -> dict:
    """The JAX exporter's reference state_dict as tensors, with the
    reference-only buffers and seeded BatchNorm counts."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jax_export(params, stats).items()}
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(int(rng.integers(1, 10**6)), dtype=torch.int64)
    sd.update({k: torch.from_numpy(rng.standard_normal(4).astype(np.float32)) for k in REFERENCE_ONLY})
    return sd


def _save(tmp_path, sd, payload: str) -> str:
    path = str(tmp_path / f"{payload}.ckpt")
    torch.save({"state_dict": sd, "epoch": 3} if payload == "state_dict" else {"model": sd} if payload == "model"
               else sd, path)
    return path


def _assert_equal(got, want, key):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("payload", ["state_dict", "model", "bare"])
def test_converter_matches_the_jax_converter(jax_trees, tmp_path, payload):
    params, stats, _ = jax_trees[True]
    ref = _reference_payload(params, stats)
    sd = convert.load_reference_state_dict(_save(tmp_path, ref, payload))
    ours, leftover = convert.convert_stereodpnet_state_dict(sd)
    jparams, jstats, jleftover = jax_convert(sd)
    assert leftover == jleftover == []
    want = state_dict_from_jax(jparams, jstats)
    assert list(ours) == list(want)
    for key, v in want.items():
        if key.endswith("num_batches_tracked"):  # the reference's counts; JAX keeps none
            assert int(v) == 0 and ours[key].dtype == torch.int64 and ours[key].shape == ()
            assert int(ours[key]) == int(ref[key]) > 0, key
        else:
            _assert_equal(ours[key], v, key)
    assert not set(REFERENCE_ONLY) & set(ours)
    model = build_model(load_config("stereodpnet"), device="cpu")
    load_state_dict(model, ours)  # strict=True


def test_converter_refuses_what_has_no_place(jax_trees, tmp_path):
    """A key the port has no place for makes the CLI raise (the JAX tool
    warns); so do the ASM InstanceNorm's two names with other values."""
    params, stats, _ = jax_trees[True]
    sd = _reference_payload(params, stats)
    out = str(tmp_path / "out.pt")
    args = ["--config", RUN_CONFIG, "--device", "cpu"]
    foreign = _save(tmp_path, {**sd, "cost_volume.attention_layer.foreign.weight": torch.ones(3)}, "state_dict")
    with pytest.raises(ValueError, match="no place"):
        convert.main([foreign, out, *args])
    assert jax_convert({**sd, "cost_volume.attention_layer.foreign.weight": torch.ones(3)})[2] == [
        "cost_volume.attention_layer.foreign.weight"]
    twice = dict(sd)
    twice["cost_volume.attention_layer.mask_convs.3.1.weight"] = twice[
        "cost_volume.attention_layer.normalize.weight"] + 1.0
    with pytest.raises(ValueError, match="same values"):
        convert.convert_stereodpnet_state_dict(twice)
    assert not os.path.exists(out)


@pytest.mark.parametrize("use_deform", [True, False])
def test_exporter_matches_the_jax_exporter(jax_trees, use_deform):
    params, stats, _ = jax_trees[use_deform]
    want = jax_export(params, stats)
    port_sd = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(params, stats).items()}
    load_state_dict(build_model(load_config("stereodpnet", model_overrides={"use_deform": use_deform}),
                                device="cpu"), port_sd)  # the port's own tree
    assert block_stack_of(port_sd) == 1  # what the CLI passes
    got = export_stereodpnet_state_dict(port_sd)
    assert list(got) == list(want)
    assert any("original_conv" in k for k in got) == (not use_deform)
    assert any("deform_conv1" in k for k in got) == use_deform
    for key, v in want.items():
        _assert_equal(got[key], np.asarray(v), key)
    # and the JAX converter of the port's export gives back the JAX tree
    back_params, back_stats, leftover = jax_convert({k: torch.from_numpy(np.array(v)) for k, v in got.items()})
    assert leftover == []
    for tree, back in ((params, back_params), (stats, back_stats)):
        a = jax.tree_util.tree_leaves_with_path(tree)
        b = jax.tree_util.tree_leaves_with_path(back)
        assert [jax.tree_util.keystr(p) for p, _ in a] == [jax.tree_util.keystr(p) for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.reshape(y, np.shape(x)), x, err_msg=jax.tree_util.keystr(path))


def test_asm_relu_prelu_as_the_jax_pair(jax_trees):
    """`asm_activation: "relu"`: the reference names no ASM PReLU. The
    converter writes its init slope 0.05, which a JAX model keeps when it
    restores the JAX converter's tree (no leaf for it), and the converted
    weights load strictly into the relu model; the exporter leaves it out,
    as the JAX exporter leaves out the tree's `PReLU_0`."""
    params, stats, _ = jax_trees[True]
    ref = _reference_payload(params, stats)
    ours, leftover = convert.convert_stereodpnet_state_dict(ref, asm_activation="relu")
    assert leftover == [] and "PReLU_0" not in jax_convert(ref)[0]["cost_volume"]["attention"]
    relu = load_config("stereodpnet", model_overrides={"asm_activation": "relu"})
    init = build_model(relu, device="cpu").state_dict()[convert.ASM_PRELU]
    assert torch.equal(ours[convert.ASM_PRELU], init) and init.tolist() == pytest.approx([0.05])
    load_state_dict(build_model(relu, device="cpu"), ours)  # strict=True

    with_prelu = jax.tree_util.tree_map(np.asarray, params)
    with_prelu["cost_volume"]["attention"]["PReLU_0"] = {"alpha": np.float32(0.3)}
    port_sd = state_dict_from_jax(with_prelu, stats)
    assert port_sd[convert.ASM_PRELU].tolist() == pytest.approx([0.3])
    got, want = export_stereodpnet_state_dict(port_sd), jax_export(with_prelu, stats)
    assert list(got) == list(want) and convert.ASM_PRELU not in got


def test_param_count_matches_jax(jax_trees):
    _, _, shapes = jax_trees[True]
    state = create_train_state(Configuration(RUN_CONFIG, make_workspace=False).get_config(), 1, device="cpu")
    assert param_count(state) == jax_param_count(SimpleNamespace(params=shapes)) > 0


def test_clis_convert_restore_strictly_and_export(jax_trees, tmp_path):
    """`python -m ...convert_stereodpnet_checkpoint ref.ckpt out.pt --config
    eval_synthetic_stereodpnet --device cpu`, then the checkpoint restored
    as `--load_model` restores it under the config's `load_strict: true`,
    then `python -m ...export_stereodpnet_checkpoint out.pt back.ckpt`: the
    reference payload again, counts included, without the reference-only
    buffers."""
    params, stats, _ = jax_trees[True]
    ref = _reference_payload(params, stats, seed=3)
    src, out, back = _save(tmp_path, ref, "state_dict"), str(tmp_path / "out.pt"), str(tmp_path / "back.ckpt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    for cmd in (["dualpixelface_tpu_torch.tools.convert_stereodpnet_checkpoint", src, out, "--config", RUN_CONFIG,
                 "--device", "cpu"],
                ["dualpixelface_tpu_torch.tools.export_stereodpnet_checkpoint", out, back]):
        run = subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]

    opt = Configuration(RUN_CONFIG, make_workspace=False).get_config()
    assert opt.load_strict is True
    state = restore_checkpoint(out, create_train_state(opt, 1, device="cpu"), strict=opt.load_strict)
    assert state.step == 0
    want, _ = convert.convert_stereodpnet_state_dict(ref)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for key, v in want.items():
        _assert_equal(got[key], v.numpy(), key)

    exported = torch.load(back, map_location="cpu")["state_dict"]
    assert set(exported) == set(ref) - set(REFERENCE_ONLY)
    for key, v in exported.items():
        _assert_equal(v, ref[key].numpy(), key)
