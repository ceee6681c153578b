"""The port's `stereodpnet` configuration against the JAX package, on the CPU.

Module by module, then whole: the exact masking attention (and the PReLU
activation in both attentions), the ASM's compat options, the ANM's
fallbacks without the deform convs or without the plane sampling, the
`stereodpnet` eval at 96x96 on two weight sets with the metric packs on
both results, one f32 train step of the JAX bench's own train cell
against JAX `make_train_step`, and the port's bench script. JAX runs as
its own tests run it on the CPU (Pallas kernels in interpret mode or
through their XLA twins); inputs and weights are made with numpy from
seeds; everything is float32 and each tolerance says why it is what it is.
"""
import json
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.config import Configuration
from dualpixelface_tpu.losses import loss_selector as jax_loss_selector
from dualpixelface_tpu.metrics import metric_selector as jax_metric_selector
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu.models.stereodpnet import normal_module as jax_nm
from dualpixelface_tpu.models.stereodpnet.modules import ASMCostVolume as JaxASMCostVolume
from dualpixelface_tpu.train.optim import optimizer_selector as jax_optimizer_selector
from dualpixelface_tpu.train.state import TrainState as JaxTrainState
from dualpixelface_tpu.train.steps import make_train_step as jax_make_train_step
from dualpixelface_tpu_torch.bench import main as bench_main
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.metrics import metric_selector
from dualpixelface_tpu_torch.models.stereodpnet.modules import ASMCostVolume
from dualpixelface_tpu_torch.models.stereodpnet.normal_module import ANM
from dualpixelface_tpu_torch.ops.precision import resolve_policy
from dualpixelface_tpu_torch.profile_train import CELLS, smooth_views, train_batch
from dualpixelface_tpu_torch.serve import Predictor
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step
from dualpixelface_tpu_torch.weights import _Mapper, load_state_dict, state_dict_from_jax
from test_torch_train import ZERO_GRAD, _capture_grads
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATEAU = os.path.join(REPO, "tests", "data", "serving_plateau_192.msgpack")
C = 8  # inplanes of the module tests: narrow, so the trees stay small


def _fill(tree, rng):
    """Seeded values for every leaf of a Flax variable tree, scaled to keep
    activations O(1): kernels by 1/sqrt(fan in), BatchNorm variances and
    norm scales in [0.5, 1.5], PReLU slopes in [0, 0.3]."""

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['kernel']", "['weight']")):
            return (rng.standard_normal(x.shape) / np.sqrt(int(np.prod(x.shape[:-1])))).astype(np.float32)
        if name.endswith(("['var']", "['scale']")):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name.endswith("['alpha']"):
            return np.asarray(rng.uniform(0.0, 0.3), np.float32).reshape(x.shape)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_opt(overrides: dict, config: str = "train_synthetic_stereodpnet"):
    cfg = Configuration(config, make_workspace=False)
    cfg.data["model"].update(overrides)
    return cfg.get_config()


def _mapped(method: str, jax_name: str, port_name: str, variables) -> dict:
    """The port's state_dict entries of one submodule named `port_name`,
    through `weights._Mapper`."""
    m = _Mapper({jax_name: variables["params"]}, {jax_name: variables.get("batch_stats", {})})
    getattr(m, method)(jax_name, port_name)
    return m.sd


def _cf(x):
    """channels-last numpy -> channels-first torch."""
    return torch.movedim(torch.from_numpy(np.ascontiguousarray(x)), -1, 1)


def _cl(t):
    """channels-first torch -> channels-last numpy."""
    return torch.movedim(t.detach(), 1, -1).numpy()


# ------------------------------------------------------------------ the ASM

def _cost_volumes(overrides: dict, train: bool, seed: int, hw=(16, 12)):
    """The JAX and the port ASMCostVolume of the `stereodpnet` config with
    `overrides` (inplanes C) on the same seeded weights and features: their
    outputs, and the attention BatchNorm's running statistics after the
    call (train mode: both call sites update them, one update each)."""
    overrides = {"inplanes": C, **overrides}
    opt = _jax_opt(overrides)
    rng = np.random.default_rng(seed)
    ref_f, tar_f = (rng.standard_normal((2,) + hw + (C,)).astype(np.float32) for _ in range(2))
    jm = JaxASMCostVolume(opt, opt.model.mindisp, opt.model.maxdisp)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ref_f), jnp.asarray(tar_f), False))
    variables = _fill(shapes, rng)
    if train:
        ref, mut = jm.apply(variables, jnp.asarray(ref_f), jnp.asarray(tar_f), True, mutable=["batch_stats"])
        ref_stats = mut["batch_stats"]["attention"]["BatchNorm_0"]
    else:
        ref, ref_stats = jm.apply(variables, jnp.asarray(ref_f), jnp.asarray(tar_f), False), None

    pt = ASMCostVolume(load_config("stereodpnet", model_overrides=overrides), opt.model.mindisp, opt.model.maxdisp)
    sd = _mapped("attention", "attention", "attention_layer",
                 {"params": variables["params"]["attention"], "batch_stats": variables["batch_stats"]["attention"]})
    load_state_dict(pt, sd).train(train)
    with torch.no_grad():
        got = pt(_cf(ref_f), _cf(tar_f))
    bn = pt.attention_layer.mask_convs[1]
    got_stats = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    return np.asarray(ref), _cl(got), ref_stats, got_stats


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("act", ["sigmoid", "relu"])
@pytest.mark.parametrize("feature_fetch", [False, True], ids=["mean", "variance"])
def test_exact_attention_matches_jax(feature_fetch, act, mode):
    """The exact attention (the head on every plane and mode; the JAX side
    in its default mode-packed layout) inside the cost volume: outputs, and
    in train mode the BatchNorm's batch statistics as they land in its
    running statistics over both call sites. f32 3x3 convs and norms, sums
    in another order."""
    ref, got, ref_stats, got_stats = _cost_volumes(
        {"fast_attention": False, "asm_activation": act, "feature_fetch": feature_fetch}, mode == "train", 20)
    assert got.shape == ref.shape == (2, 8, 16, 12, 2 * C)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if mode == "train":
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_stats[k], np.asarray(ref_stats[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_fast_attention_prelu_matches_jax(mode):
    """`asm_activation: "relu"` in the hoisted-head attention, as in the
    exact one: a PReLU (init 0.05) before the softmax over the modes."""
    ref, got, ref_stats, got_stats = _cost_volumes({"fast_attention": True, "asm_activation": "relu"},
                                                   mode == "train", 21)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if mode == "train":
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_stats[k], np.asarray(ref_stats[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("option", ["compat_nearest", "compat_frozen_shift_grid", "both"])
def test_compat_options_match_jax(option):
    """The reference's stretched nearest grid and its frozen shift grid,
    through the exact-attention cost volume (H = 16: even, so the stretch
    zeroes the last rows), and that each option changes the volume."""
    flags = ("compat_nearest", "compat_frozen_shift_grid") if option == "both" else (option,)
    ref, got, _, _ = _cost_volumes(dict.fromkeys(flags, True), False, 22)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    plain, _, _, _ = _cost_volumes({}, False, 22)
    assert np.abs(ref - plain).max() > 1e-2


# ------------------------------------------------------------------ the ANM

@pytest.mark.parametrize("option", ["use_deform", "use_sampling"])
def test_anm_fallbacks_match_jax(option):
    """The normal branch with `option` off: `use_deform=false`, the
    ConvBN3D pair on the sampled planes (no offsets); `use_sampling=false`,
    the deform convs on all D = 8 planes, at the plane grid's values (so
    the windowed deform falls back to unbounded). Both on the same cost and
    disparity; two 3-D convs and a 6-layer dilated stack in f32, then a
    sigmoid."""
    hw = 64
    opt = _jax_opt({"inplanes": C, option: False, "deform_impl": "pallas"})
    rng = np.random.default_rng(23)
    cost = rng.standard_normal((1, 8, hw // 4, hw // 4, C)).astype(np.float32)
    disp = rng.uniform(-4, 12, (1, hw, hw)).astype(np.float32)
    batch = {k: v for k, v in _tiny_batch(1, hw, hw).items() if k in ("K", "abvalue")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_nm.ANM(opt, opt.model.mindisp, opt.model.maxdisp)
    args = ([jnp.asarray(cost)], [jnp.asarray(disp)], jbatch, False)
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args)), rng)
    if option == "use_sampling":  # non-zero offset heads, so the deform convs sample off the grid
        for i in (1, 2):
            off = variables["params"][f"deform_conv{i}"]["conv_offset"]
            off["kernel"] = off["kernel"] * 4.0
    normals, off1s, _ = jm.apply(variables, *args)

    pt = ANM(load_config("stereodpnet", model_overrides={"inplanes": C, option: False, "deform_impl": "pallas"}),
             opt.model.mindisp, opt.model.maxdisp)
    load_state_dict(pt, {k.removeprefix("anm."): v for k, v in _mapped("anm", "anm", "anm", variables).items()}).eval()
    with torch.no_grad():
        normal, off1, off2 = pt(_cf(cost), torch.from_numpy(disp), {k: torch.from_numpy(v) for k, v in batch.items()})
    if option == "use_deform":
        assert off1 is None and off2 is None and off1s[0] is None
        assert not hasattr(pt, "deform_conv1")
    else:
        assert tuple(off1.shape) == off1s[0].shape == (1, 8, hw // 4, hw // 4, 81)
        assert float(np.abs(np.asarray(off1s[0])).max()) > 3.0  # past the +-3 window
        np.testing.assert_allclose(off1.numpy(), np.asarray(off1s[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(normal.numpy(), np.asarray(normals[0]), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ the eval

HW = 96


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX `stereodpnet` model (exact attention in its default
    mode-packed layout, unbounded packed8 deform, unfused regression), its
    jitted eval, the batch, and two weight sets: a seeded init whose deform
    offset heads carry seeded noise (at init they are zero and the deform
    convs would sample only the grid), and the committed plateau
    checkpoint (trained as stereodpnet_plus; the two configs share one
    variable tree)."""
    opt = Configuration("train_synthetic_stereodpnet", make_workspace=False).get_config()
    model = jax_model_selector(opt)
    batch_np = _tiny_batch(1, HW, HW)
    batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
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
    return opt, {"seeded-noisy-offsets": noisy, "plateau-checkpoint": plateau}, apply, batch, batch_np


@pytest.fixture(scope="module")
def eval_results(jax_eval):
    """Each weight set's JAX and port results."""
    _, weight_sets, apply, batch, batch_np = jax_eval
    out = {}
    for name, v in weight_sets.items():
        ref = jax.tree_util.tree_map(np.asarray, apply(v, batch))
        got = Predictor(load_config("stereodpnet"), state_dict_from_jax(v["params"], v["batch_stats"]),
                        device="cpu", dtype=torch.float32)(batch_np)
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("weights", ["seeded-noisy-offsets", "plateau-checkpoint"])
def test_stereodpnet_eval_matches_jax(eval_results, weights):
    """Depth, normals and the probability volume, at the tolerances of the
    stereodpnet_plus eval test (`tests/test_torch_slice.py`)."""
    ref, got = eval_results[weights]
    assert set(got) == set(ref) == {"pred_depth", "prob_depth", "pred_normal", "ref_feature"}
    for key in ("pred_depth", "prob_depth", "pred_normal", "ref_feature"):
        assert tuple(got[key].shape) == ref[key].shape, key
    assert tuple(got["prob_depth"].shape) == (1, 1, 32, HW, HW)
    # depth: f32 through ~60 layers with sums in another order, then a
    # softmax over 32 bins; disparities span [-4, 12]; the probabilities
    # and the features as ref_feature
    assert np.abs(got["pred_depth"].numpy() - ref["pred_depth"]).max() < 2e-3
    np.testing.assert_allclose(got["prob_depth"].numpy(), ref["prob_depth"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["ref_feature"].numpy(), ref["ref_feature"], rtol=1e-4, atol=1e-4)
    # normals: a pixel whose quarter-scale disparity sits on a plane boundary
    # may take the other sample_with_sort window when depth differs by float
    # noise, so hold a share of the components, and the mean
    diff = np.abs(got["pred_normal"].numpy() - ref["pred_normal"])
    assert (diff <= 1e-3).mean() >= 0.995
    assert diff.mean() < 1e-4


@pytest.mark.parametrize("weights", ["seeded-noisy-offsets", "plateau-checkpoint"])
def test_stereodpnet_eval_metrics_match_jax(jax_eval, eval_results, weights):
    """The port's metric packs on the port's result against the JAX packs
    on JAX's: depth RMSE and the normals' mean angle within BASELINE.md's
    0.5% relative, every other key within 1e-4 (of max(1, |JAX's|)) but
    the affine pack's 1 - Spearman: a rank statistic, and the plateau
    checkpoint's disparities on noise views hold large groups of exactly
    equal values (6261 distinct of 9216 on the JAX side, 6252 on the
    port's), whose ranks argsort orders by position; float noise of 6e-5
    between the two results regroups them and moved 1 - Spearman by
    1.4e-3 (both packs give the same value on the same input:
    `tests/test_torch_metrics.py`), so it is held to the 0.5% budget."""
    opt, _, _, _, batch_np = jax_eval
    ref, got = eval_results[weights]
    want = jax_metric_selector(opt)({k: jnp.asarray(v) for k, v in ref.items()},
                                    {k: jnp.asarray(v) for k, v in batch_np.items()})
    bank = metric_selector(load_config("stereodpnet"))
    have = bank(got, batch_np)
    assert set(have) == set(want) == {"absolute_dp", "affine_dp", "normal_dp"}
    budget = {("absolute_dp", "rmse"), ("normal_dp", "mean_angle_deg"), ("affine_dp", "spearman")}
    for bench in bank.benchmarks:
        pack = bench.registry_name
        for key, h, w in zip(bench.keys, have[pack], want[pack]):
            tol = 5e-3 if (pack, key) in budget else 1e-4
            assert abs(float(h) - float(w)) <= tol * max(1.0, abs(float(w))), (pack, key, h, w)


# ------------------------------------------------------------------ the train step

TRAIN_HW = 32  # the train step's crop: ANM volume [2, 4, 8, 8, C]
VIEWS_SEED = 1002


@pytest.fixture(scope="module")
def jax_bench_step():
    """One JAX train step of the JAX bench's own train cell (`bench.py`:
    `stereodpnet`, exact attention, windowed `pallas` deform without the
    offset clamp, fused regression), in f32 with Adam, batch 2 at 32x32,
    from the committed plateau checkpoint on smooth views: the weights
    before, the batch, and the losses, gradients, batch statistics and
    weights after.

    The point is chosen as `tests/test_torch_train.py::jax_step` says (the
    f32 gradient must be a continuous function of rounding there). Exact
    attention and the clamp off move the kinks, and its views seed 1004 is
    not free of flips here: a tower PReLU's gradient differs from JAX's by
    2e-2 in the port's f32 and f64 alike. Of the seeds 1000-1009 tried in
    order (1004, 1008, 1009, 1000, 1002), 1002 is the first where the port
    in f32 on 1, 2 and 4 threads and in f64 takes every kink as JAX does
    (largest per-parameter gradient difference 1.0e-4 to 1.2e-4, the f32
    and f64 ports deciding every kink alike); the deform convs sample 104
    and 247 of their 13824 positions outside the +-3 window, where the
    window clamps them."""
    cfg = Configuration("train_synthetic_stereodpnet", make_workspace=False)
    cfg.data["model"].update(CELLS["bench"][1])
    opt = cfg.get_config()
    model = jax_model_selector(opt)
    batch_np = {**train_batch(2, TRAIN_HW, TRAIN_HW), **smooth_views(2, TRAIN_HW, TRAIN_HW, seed=VIEWS_SEED)}
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    template = jax.jit(lambda k, b: model.init(k, b, train=False))(jax.random.PRNGKey(0), batch)
    with open(PLATEAU, "rb") as f:
        init = jax.tree_util.tree_map(np.array, flax.serialization.from_bytes(template, f.read()))
    tx = optax.chain(_capture_grads(), jax_optimizer_selector(opt, 100))
    state = JaxTrainState.create(apply_fn=model.apply, params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                                 batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]), tx=tx)
    new, losses = jax_make_train_step(model, jax_loss_selector(opt), jnp.float32)(state, batch)
    after = jax.tree_util.tree_map(np.array, {"params": new.params, "batch_stats": new.batch_stats,
                                              "grads": new.opt_state[0]})
    return opt, init, batch_np, {k: float(v) for k, v in losses.items()}, after


@pytest.fixture(scope="module")
def port_bench_step(jax_bench_step):
    """The port's step of the same cell (`profile_train.CELLS["bench"]`,
    the f32 policy of the default run keys) from the same weights on the
    same batch, and the offsets of both deform convs."""
    _, init, batch_np, _, _ = jax_bench_step
    cfg = load_config(CELLS["bench"][0], model_overrides=CELLS["bench"][1])
    assert not cfg.model.get("deform_offset_clamp", False) and not cfg.model.get("fast_attention", False)
    state = create_train_state(cfg, 100, state_dict=state_dict_from_jax(init["params"], init["batch_stats"]),
                               device="cpu")
    offsets = []
    hooks = [state.model.normal_estimator.get_submodule(f"deform_conv{i}").register_forward_hook(
        lambda m, i, o: offsets.append(o[1].detach().numpy())) for i in (1, 2)]
    state, losses = make_train_step(state.model, loss_selector(cfg), resolve_policy(cfg))(state, batch_np)
    for h in hooks:
        h.remove()
    return state, {k: float(v) for k, v in losses.items()}, offsets


def test_bench_train_step_losses_match_jax(jax_bench_step, port_bench_step):
    """Losses within 1e-4 relative (7e-7 measured), with the window binding
    on unclamped offsets: sampling positions outside +-3 in both convs."""
    _, _, _, ref, _ = jax_bench_step
    _, got, offsets = port_bench_step
    kh, kw = (np.arange(27) // 3) % 3 - 1, np.arange(27) % 3 - 1
    for off in offsets:
        off = off.reshape(off.shape[:4] + (27, 3))
        rh, rw = kh + off[..., 1], kw + off[..., 2]
        assert ((rh < -3) | (rh >= 4 - 1 / 1024) | (rw < -3) | (rw >= 4 - 1 / 1024)).any()
    assert set(got) == set(ref) == {"smoothL1_loss", "cosine_loss", "final_loss"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-4), key


def test_bench_train_step_gradients_match_jax(jax_bench_step, port_bench_step):
    """Per parameter, ||port - JAX|| <= 1e-3 ||JAX|| (1.2e-4 the largest
    measured), mapped through `state_dict_from_jax`; the two deform-conv
    biases whose exact gradient is zero (each feeds a batch-statistics
    BatchNorm) within 1e-6 of their conv weight's gradient norm in both."""
    _, init, _, _, after = jax_bench_step
    state, _, _ = port_bench_step
    ref = state_dict_from_jax(after["grads"], init["batch_stats"])
    bad = {}
    for name, p in state.model.named_parameters():
        g = p.grad.numpy()
        if name in ZERO_GRAD:
            scale = float(np.linalg.norm(ref[name.replace(".bias", ".weight")]))
            if not max(np.linalg.norm(g), np.linalg.norm(ref[name])) <= 1e-6 * scale:
                bad[name] = (float(np.linalg.norm(g)), float(np.linalg.norm(ref[name])), scale)
            continue
        rel = float(np.linalg.norm(g - ref[name]) / np.linalg.norm(ref[name]))
        if not rel <= 1e-3:
            bad[name] = rel
    assert not bad, sorted(bad.items(), key=lambda kv: str(kv[1]))[:10]


def test_bench_train_step_batch_stats_and_update_match_jax(jax_bench_step, port_bench_step):
    """Batch statistics after the step against JAX (the exact attention's
    BatchNorm updated once per call site, as in JAX); the port's Adam
    update against optax applied to the port's own gradients (an f32 ulp);
    and each parameter's update against JAX's within 1e-3 of its norm plus
    what the two gradients' difference moves it by through Adam's first
    step, u = -lr g / (|g| + eps), whose slope lr eps / (|g| + eps)^2 is
    large where |g| is near eps = 1e-5: a BatchNorm bias of block1 has an
    entry of 1.9e-6, whose 1e-7 gradient difference (1.6e-6 of that
    gradient's norm) moves its update by 4.5%, 1.26e-3 of the bias's update
    norm. The two zero-gradient biases: within 1e-7 = lr / 1e3 absolute."""
    opt, init, _, _, after = jax_bench_step
    state, _, _ = port_bench_step
    ref = state_dict_from_jax(after["params"], after["batch_stats"])
    before = state_dict_from_jax(init["params"], init["batch_stats"])
    grads = state_dict_from_jax(after["grads"], init["batch_stats"])
    sd = state.model.state_dict()
    for name in ref:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), ref[name], rtol=1e-4, atol=1e-6, err_msg=name)

    params = dict(state.model.named_parameters())
    tx = jax_optimizer_selector(opt, 100)
    p0 = {k: jnp.asarray(before[k]) for k in params}
    upd, _ = tx.update({k: jnp.asarray(p.grad.numpy()) for k, p in params.items()}, tx.init(p0), p0)
    mine = optax.apply_updates(p0, upd)
    lr, eps = 1e-4, 1e-5
    assert opt.init_lr == lr
    bad = {}
    for name, p in params.items():
        got = p.detach().numpy()
        # torch.optim.Adam and optax round in another order: an f32 ulp
        np.testing.assert_allclose(got, np.asarray(mine[name]), rtol=2.5e-7, atol=1e-8, err_msg=name)
        d_got, d_ref = got - before[name], ref[name] - before[name]
        if name in ZERO_GRAD:
            err = max(np.abs(d_got).max(), np.abs(d_ref).max()) / 1e-7
        else:
            g_ref = grads[name].astype(np.float64)
            moved = lr * eps / (np.abs(g_ref) + eps) ** 2 * np.abs(p.grad.numpy() - g_ref)
            err = np.linalg.norm(d_got - d_ref) / (1e-3 * np.linalg.norm(d_ref) + np.linalg.norm(moved))
        if not err <= 1.0:
            bad[name] = float(err)
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]


# ------------------------------------------------------------------ the bench script

def test_bench_script_prints_the_bench_keys():
    """`python -m dualpixelface_tpu_torch.bench --device cpu --hw 64
    --iters 1` prints one JSON line with `bench.py`'s keys (each rate a
    positive number, here the CPU's) and no TPU anchor, baseline ratio,
    probe or drift field."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-m", "dualpixelface_tpu_torch.bench", "--device", "cpu", "--hw", "64",
                          "--iters", "1"], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("value", "train_step_pairs_per_sec_b2", "stereodpnet_exact_fwd_pairs_per_sec",
                "stereodpnet_plus_fwd_pairs_per_sec"):
        assert isinstance(line[key], float) and line[key] > 0, key
    assert line["metric"] == "stereodpnet_fwd_dp_pairs_per_sec_per_chip_64x64"
    assert line["device"] == "cpu" and line["card"] is None and line["batch"] == 4
    assert not {k for k in line if k.startswith(("anchor", "vs_baseline", "probe", "session_drift", "stale"))}


def test_bench_script_refuses_to_run_without_cuda():
    """Without a card and without `--device cpu` the bench raises, as the
    other entry points do; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_main(["--hw", "64", "--iters", "1"])
