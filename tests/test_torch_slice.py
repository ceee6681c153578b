"""The PyTorch port's serving slice against the JAX package, on the CPU.

The whole `stereodpnet_plus` eval at 96x96, batch 1, float32, on the port
(plain versions of the kernels) and on JAX run as its own tests run it
(fused soft-argmin in Pallas interpret mode, the deform kernel through its
windowed XLA twin, f32 offset heads through the XLA fold), with two weight
sets: a seeded JAX init whose deform offset heads carry seeded noise (at
init they are zero and the deform convs would sample only the grid), and
the committed plateau checkpoint. Plus the weight bridge, import hygiene,
and the entry point's refusal to run on a machine without CUDA.
"""
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.config import Configuration
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.serve import Predictor
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.weights import load_state_dict, read_flax_msgpack, state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from export_stereodpnet_checkpoint import export_stereodpnet_state_dict  # noqa: E402
from torch_cpu_setup import two_threads  # noqa: E402

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATEAU = os.path.join(REPO, "tests", "data", "serving_plateau_192.msgpack")
HW = 96


@pytest.fixture(scope="module")
def jax_side():
    """The JAX stereodpnet_plus model, its jitted eval, and two weight sets."""
    opt = Configuration("train_synthetic_stereodpnet_plus", make_workspace=False).get_config()
    model = jax_model_selector(opt)
    batch = jax.tree_util.tree_map(jnp.asarray, _tiny_batch(1, HW, HW))
    init = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k, b: model.init(k, b, train=False))(jax.random.PRNGKey(0), batch)
    )
    rng = np.random.default_rng(0)
    noisy = jax.tree_util.tree_map(np.array, init)
    for i in (1, 2):
        off = noisy["params"]["normal_estimator"][f"deform_conv{i}"]["conv_offset"]
        fan_in = int(np.prod(off["kernel"].shape[:-1]))
        off["kernel"] = (rng.standard_normal(off["kernel"].shape) * 2.0 / np.sqrt(fan_in)).astype(np.float32)
        off["bias"] = rng.standard_normal(off["bias"].shape).astype(np.float32)
    with open(PLATEAU, "rb") as f:
        plateau = jax.tree_util.tree_map(np.asarray, flax.serialization.from_bytes(init, f.read()))
    apply = jax.jit(lambda v, b: model.apply(v, b, train=False))
    return {"seeded-noisy-offsets": noisy, "plateau-checkpoint": plateau}, apply, batch


def test_read_flax_msgpack_matches_flax():
    """The port's Flax-free reader gives the committed checkpoint's tree as
    `flax.serialization.msgpack_restore` does: the same keys, dtypes and
    values."""
    ours = read_flax_msgpack(PLATEAU)
    with open(PLATEAU, "rb") as f:
        theirs = flax.serialization.msgpack_restore(f.read())
    a, b = jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves_with_path(theirs)
    assert [jax.tree_util.keystr(p) for p, _ in a] == [jax.tree_util.keystr(p) for p, _ in b]
    assert len(a) == 435
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def test_state_dict_matches_exporter_and_loads_strictly(jax_side):
    weight_sets, _, _ = jax_side
    v = weight_sets["seeded-noisy-offsets"]
    ours = state_dict_from_jax(v["params"], v["batch_stats"])
    theirs = export_stereodpnet_state_dict(v["params"], v["batch_stats"])
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    model = build_model(load_config("stereodpnet_plus"), device="cpu")
    load_state_dict(model, ours)  # strict=True
    assert set(model.state_dict()) == set(ours)


@pytest.mark.parametrize("weights", ["seeded-noisy-offsets", "plateau-checkpoint"])
def test_stereodpnet_plus_eval_matches_jax(jax_side, weights):
    weight_sets, apply, batch = jax_side
    v = weight_sets[weights]
    ref = jax.tree_util.tree_map(np.asarray, apply(v, batch))
    pred = Predictor(load_config("stereodpnet_plus"), state_dict_from_jax(v["params"], v["batch_stats"]),
                     device="cpu", dtype=torch.float32)
    got = pred(_tiny_batch(1, HW, HW))

    assert got["prob_depth"] is None and ref["prob_depth"] is None
    for key in ("pred_depth", "pred_normal", "ref_feature"):
        assert tuple(got[key].shape) == ref[key].shape, key
    # depth: f32 through ~60 layers with sums in another order, then a
    # softmax over 32 bins; disparities span [-4, 12]
    assert np.abs(got["pred_depth"].numpy() - ref["pred_depth"]).max() < 2e-3
    np.testing.assert_allclose(got["ref_feature"].numpy(), ref["ref_feature"], rtol=1e-4, atol=1e-4)
    # normals: a pixel whose quarter-scale disparity sits on a plane boundary
    # may take the other sample_with_sort window when depth differs by float
    # noise, so hold a share of the components, and the mean
    diff = np.abs(got["pred_normal"].numpy() - ref["pred_normal"])
    assert (diff <= 1e-3).mean() >= 0.995
    assert diff.mean() < 1e-4


@pytest.fixture(scope="module")
def jax_offsets_apply():
    """The JAX stereodpnet_plus eval with `return_offsets` set, jitted."""
    opt = Configuration("train_synthetic_stereodpnet_plus", make_workspace=False).get_config()
    opt.model.return_offsets = True
    model = jax_model_selector(opt)
    return jax.jit(lambda v, b: model.apply(v, b, train=False))


@pytest.mark.parametrize("weights", ["seeded-noisy-offsets", "plateau-checkpoint"])
def test_return_offsets_matches_jax(jax_side, jax_offsets_apply, weights):
    """With `return_offsets` set, both packages add the ANM deform convs'
    offsets (after the offset clamp) as anm_offset1 / anm_offset2, in JAX's
    layout [B, D, h, w, 81]; the port's agree with JAX's to ref_feature's
    tolerance (f32 through the tower, cost volume and aggregation)."""
    weight_sets, _, batch = jax_side
    v = weight_sets[weights]
    ref = jax.tree_util.tree_map(np.asarray, jax_offsets_apply(v, batch))
    config = load_config("stereodpnet_plus", model_overrides={"return_offsets": True})
    got = Predictor(config, state_dict_from_jax(v["params"], v["batch_stats"]), device="cpu",
                    dtype=torch.float32)(_tiny_batch(1, HW, HW))
    assert set(got) == set(ref)
    for key in ("anm_offset1", "anm_offset2"):
        assert tuple(got[key].shape) == ref[key].shape == (1, 4, HW // 4, HW // 4, 81), key
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_offsets_only_on_request(jax_side):
    """Without `return_offsets` neither package returns the offsets."""
    weight_sets, apply, batch = jax_side
    v = weight_sets["seeded-noisy-offsets"]
    ref = apply(v, batch)
    got = Predictor(load_config("stereodpnet_plus"), state_dict_from_jax(v["params"], v["batch_stats"]),
                    device="cpu", dtype=torch.float32)(_tiny_batch(1, HW, HW))
    assert set(got) == set(ref) == {"pred_depth", "prob_depth", "pred_normal", "ref_feature"}


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, flax and the JAX
    package out of sys.modules."""
    code = (
        "import pkgutil, sys, dualpixelface_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[__import__(n) for n in names]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'dualpixelface_tpu'))\n"
        "assert len(names) > 15 and not bad, (len(names), bad)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_entry_points_refuse_to_run_without_cuda():
    """Without CUDA and without an explicit CPU request, the entry points
    raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = load_config("stereodpnet_plus")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, steps_per_epoch=1)
