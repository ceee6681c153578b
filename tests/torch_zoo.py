"""What the zoo's CPU test files share (`tests/test_torch_stereonet.py`,
`test_torch_psmnet.py`, `test_torch_nnet.py`, `test_torch_dpnet.py`,
`test_torch_bts.py`): the cost-volume ops, the eval forward, one f32 train
step and `Trainer.fit` / `test`, each of the port against the JAX package
on the same numpy inputs and weights.

Weights: the JAX model's own variable tree (`init` under `eval_shape`),
every leaf refilled from a seed (`fill`) so that activations stay O(1).
The JAX init itself (He-normal convs, BatchNorm at identity) grows the
activations layer by layer (psmnet's ref_feature reaches ~7e3 at 64x64),
so the soft-argmin saturates and the comparison tells nothing about its
logits. The tree crosses to the port through `weights.state_dict_from_jax`
and loads with strict=True.
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.losses import loss_selector as jax_loss_selector
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu.ops import cost_volume as jax_cv
from dualpixelface_tpu.train.optim import optimizer_selector as jax_optimizer_selector
from dualpixelface_tpu.train.state import TrainState as JaxTrainState
from dualpixelface_tpu.train.steps import make_train_step as jax_make_train_step
from dualpixelface_tpu_torch.config import Configuration
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.ops import cost_volume as cv
from dualpixelface_tpu_torch.ops.precision import resolve_policy
from dualpixelface_tpu_torch.profile_train import smooth_views, train_batch
from dualpixelface_tpu_torch.serve import Predictor
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step
from dualpixelface_tpu_torch.train.trainer import Trainer
from dualpixelface_tpu_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
RUN_CONFIG = {"stereonet": "train_faceDP_stereonet", "psmnet": "train_faceDP_psmnet", "nnet": "train_faceDP_nnet",
              "dpnet": "train_faceDP_dpnet", "bts": "train_faceDP_bts",
              "stereodpnet_plus": "train_synthetic_stereodpnet_plus"}  # tests/test_torch_widths.py's other widths
HW = 64  # psmnet's and nnet's SPP pools at inplanes 8 (windows 16..2) fit its 16x16 features
# dpnet's five heads land on the full resolution only for multiples of 96
SIZE = {"dpnet": 96}
B = 2


def size_of(model: str) -> int:
    return SIZE.get(model, HW)


def options(model: str, over: dict, run_over: dict | None = None):
    """The JAX and the port's merged run config of `model`'s FaceDP run
    config (flip_lr true), its run keys overridden by `run_over` and its
    model keys by `over`."""
    out = []
    for cls in (JaxConfiguration, Configuration):
        cfg = cls(RUN_CONFIG[model], make_workspace=False, overrides=run_over)
        cfg.data["model"].update(over)
        out.append(cfg.get_config())
    return out


def fill(tree, rng):
    """Seeded values for every leaf of a Flax variable tree: kernels by
    1/sqrt(fan in), BatchNorm variances and scales in [0.5, 1.5], biases and
    means 0.1 N(0, 1)."""

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.standard_normal(x.shape) / np.sqrt(int(np.prod(x.shape[:-1])))).astype(np.float32)
        if name.endswith(("['var']", "['scale']")):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def views_batch(views_seed: int, b: int = B, hw: int = HW) -> dict:
    """The bench recipe's train batch (depth, disparity, normals, mask, K,
    abvalue) with smooth views from `views_seed`."""
    return {**train_batch(b, hw, hw), **smooth_views(b, hw, hw, seed=views_seed)}


def seeded_model(model: str, over: dict, batch_np: dict, seed: int, adjust=None, run_over=None):
    """(JAX option, port option, JAX module, variables as numpy) with the
    JAX tree refilled from `seed`, then passed through `adjust(variables,
    port option)` where given."""
    jopt, popt = options(model, over, run_over)
    jm = jax_model_selector(jopt)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, train=False))
    variables = fill(shapes, np.random.default_rng(seed))
    return jopt, popt, jm, variables if adjust is None else adjust(variables, popt)


def port_weights(model: str, variables) -> dict:
    return state_dict_from_jax(variables["params"], variables["batch_stats"], model=model)


# ------------------------------------------------------------------ the volumes

PLANES = cv.costrange(-4, 12, 8)  # -1 .. 2.5 by 0.5: int() gives -1, 0 (from -0.5), 0, 0, 1, 1, 2, 2


def volumes(kind: str, seed: int = 5, groups: int = 4):
    """(JAX, port) volume `kind` over PLANES on the same seeded features
    [2, 16, 12, 8], the port's moved to channels-last [B, D, H, W, C*]."""
    rng = np.random.default_rng(seed)
    ref, tar = (rng.standard_normal((2, 16, 12, 8)).astype(np.float32) for _ in range(2))
    args = {"subtraction": (), "concat": (), "gwc": (groups,)}[kind]
    jfn = {"subtraction": jax_cv.subtraction_volume, "concat": jax_cv.concat_volume_int, "gwc": jax_cv.gwc_volume}
    pfn = {"subtraction": cv.subtraction_volume, "concat": cv.concat_volume_int, "gwc": cv.gwc_volume}
    want = np.asarray(jfn[kind](jnp.asarray(ref), jnp.asarray(tar), PLANES, *args))
    cf = [torch.movedim(torch.from_numpy(a), -1, 1) for a in (ref, tar)]
    got = torch.movedim(pfn[kind](*cf, PLANES, *args), 1, -1).numpy()
    return want, got


def check_volumes(kind: str) -> None:
    """Every plane, shifts -1, 0 and +1, +2 included, to 1e-6 (the same
    f32 products and, for gwc, a mean of 2 in another order); the row masks
    equal, and each plane of the port's zero outside its valid rows."""
    assert sorted({int(d) for d in PLANES}) == [-1, 0, 1, 2]
    want, got = volumes(kind)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for d in PLANES:
        k = int(d)
        np.testing.assert_array_equal(cv.row_valid_mask(16, k).numpy(), np.asarray(jax_cv.row_valid_mask(16, k))[:, :, 0])
    for i, d in enumerate(PLANES):
        k = int(d)
        dead = slice(16 - k, 16) if k > 0 else slice(0, -k)
        assert not got[:, i, dead].any()
        assert np.abs(got[:, i]).max() > 0.1


# ------------------------------------------------------------------ the eval

def eval_pair(model: str, over: dict, seed: int = 11, views_seed: int = 3, adjust=None):
    """The JAX eval forward and the port's (`Predictor`, f32, CPU) on the
    same seeded weights and batch, at the model's size."""
    batch_np = views_batch(views_seed, hw=size_of(model))
    _, popt, jm, variables = seeded_model(model, over, batch_np, seed, adjust)
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), {k: jnp.asarray(v) for k, v in batch_np.items()})
    ref = {k: None if v is None else np.asarray(v) for k, v in ref.items()}
    got = Predictor(popt, port_weights(model, variables), device="cpu", dtype=torch.float32)(batch_np)
    return ref, got


# absolute tolerances of the eval keys (rtol 1e-4 for all): f32 through
# 20-70 layers with sums in another order, then a softmax. The depth is
# the softmax's mean over bins spanning 16 disparity units, which moves by
# up to 16x a logit's rounding where the probability is spread: 2e-3, as
# tests/test_torch_stereodpnet.py holds depth. nnet's normal is n / |n| of
# a summed 3-channel map, which divides the rounding by |n| where the map
# is near 0: 1e-3 (3.3e-4 the largest measured). The rest 1e-4.
EVAL_ATOL = {"pred_depth": 2e-3, "pred_normal": 1e-3}


def check_eval(ref: dict, got: dict, shapes: dict) -> None:
    """Every result key: the shape, and the values to rtol 1e-4 and the
    key's EVAL_ATOL (None keys None in both)."""
    assert set(got) == set(ref) == set(shapes)
    for key, shape in shapes.items():
        if shape is None:
            assert got[key] is None and ref[key] is None, key
            continue
        assert tuple(got[key].shape) == ref[key].shape == shape, key
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-4, atol=EVAL_ATOL.get(key, 1e-4),
                                   err_msg=key)


# ------------------------------------------------------------------ the train step

def _capture_grads():
    """An optax stage that passes the gradients on and keeps them as its
    state, so one `make_train_step` call yields them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def jax_step(model: str, over: dict, views_seed: int, seed: int = 13, adjust=None, run_over=None, extend=None,
             hw: int | None = None):
    """One JAX train step (f32, the run config's Adam) of batch 2 at the
    model's size (or `hw`): (port option, weights before, batch, losses,
    {params, batch_stats, grads} after). `run_over` overrides run keys;
    `extend(batch)` gives keys to add to the batch."""
    batch_np = views_batch(views_seed, hw=hw or size_of(model))
    if extend is not None:
        batch_np.update(extend(batch_np))
    jopt, popt, jm, init = seeded_model(model, over, batch_np, seed, adjust, run_over)
    tx = optax.chain(_capture_grads(), jax_optimizer_selector(jopt, 100))
    state = JaxTrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                                 batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]), tx=tx)
    new, losses = jax_make_train_step(jm, jax_loss_selector(jopt), jnp.float32)(
        state, {k: jnp.asarray(v) for k, v in batch_np.items()})
    after = jax.tree_util.tree_map(np.array, {"params": new.params, "batch_stats": new.batch_stats,
                                              "grads": new.opt_state[0]})
    return popt, init, batch_np, {k: float(v) for k, v in losses.items()}, after


def port_step(model: str, popt, init, batch_np):
    """The port's step from the same weights on the same batch (the run
    config's f32 policy, Adam, on the CPU): (state, losses)."""
    assert resolve_policy(popt) == torch.float32
    state = create_train_state(popt, 100, state_dict=port_weights(model, init), device="cpu")
    state, losses = make_train_step(state.model, loss_selector(popt), resolve_policy(popt))(state, batch_np)
    return state, {k: float(v) for k, v in losses.items()}


def gradient_errors(model: str, jstep, pstep, zero_grad=()) -> dict:
    """Per parameter, ||port - JAX|| / ||JAX|| of the gradient; for the
    parameters of `zero_grad`, whose exact gradient is zero, the larger of
    the two norms over their conv weight's gradient norm."""
    _, init, _, _, after = jstep
    state, _ = pstep
    ref = port_weights(model, {"params": after["grads"], "batch_stats": init["batch_stats"]})
    errs = {}
    for name, p in state.model.named_parameters():
        g = p.grad.numpy()
        if name in zero_grad:
            scale = np.linalg.norm(ref[name.replace(".bias", ".weight")])
            errs[name] = float(max(np.linalg.norm(g), np.linalg.norm(ref[name])) / scale)
        else:
            errs[name] = float(np.linalg.norm(g - ref[name]) / np.linalg.norm(ref[name]))
    return errs


def update_errors(model: str, jstep, pstep, zero_grad=()) -> dict:
    """Each parameter's update against JAX's, over 1e-3 of its norm plus
    what the two gradients' difference moves it by through Adam's first
    step, u = -lr g / (|g| + eps), whose slope lr eps / (|g| + eps)^2 is
    large where |g| is near eps (tests/test_torch_stereodpnet.py takes that
    slope; here the two steps' difference itself, as entries with |g| far
    below eps differ in relative terms by more than the slope's reach). The
    parameters of `zero_grad`: their gradient is either package's
    rounding, which may reach eps, and Adam's first step turns it into a
    move of up to lr either way; the larger update over lr."""
    popt, init, _, _, after = jstep
    state, _ = pstep
    ref = port_weights(model, after)
    before = port_weights(model, init)
    grads = port_weights(model, {"params": after["grads"], "batch_stats": init["batch_stats"]})
    lr, eps = float(popt.init_lr), 1e-5
    errs = {}
    for name, p in state.model.named_parameters():
        d_got, d_ref = p.detach().numpy() - before[name], ref[name] - before[name]
        if name in zero_grad:
            errs[name] = float(max(np.abs(d_got).max(), np.abs(d_ref).max()) / lr)
            continue
        g_ref, g_got = grads[name].astype(np.float64), p.grad.numpy().astype(np.float64)
        moved = lr * (g_got / (np.abs(g_got) + eps) - g_ref / (np.abs(g_ref) + eps))
        errs[name] = float(np.linalg.norm(d_got - d_ref) / (1e-3 * np.linalg.norm(d_ref) + np.linalg.norm(moved)))
    return errs


def check_batch_stats(model: str, jstep, pstep) -> int:
    """Every BatchNorm's running statistics after the step against JAX's
    (rtol 1e-4, atol 1e-6: f32 moments in another order); returns how many
    buffers were held."""
    _, _, _, _, after = jstep
    state, _ = pstep
    ref = port_weights(model, after)
    sd = state.model.state_dict()
    names = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    for name in names:
        np.testing.assert_allclose(sd[name].numpy(), ref[name], rtol=1e-4, atol=1e-6, err_msg=name)
    return len(names)


# ------------------------------------------------------------------ the trainer

def fit_and_restore(tmp_path, model: str, over: dict, hw: int = 96, crop_factor: int = 32):
    """`Trainer.fit` (one epoch) then `test()` on the CPU, as
    tests/test_trainer_zoo.py sets the JAX trainer up: the run config
    train_synthetic_stereonet with `model_name` set, batch 4, SyntheticDP at
    hw x hw (8 train, 4 test samples; 96 unless given), crop factor 32
    unless given, `use_normal` for nnet; then a fresh trainer restoring the
    epoch's checkpoint in test mode.
    Returns (train records, test records, checkpoints, first tables,
    restored tables)."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "configs", root / "configs")

    def option(workspace, mode="train", load_model=None):
        cfg = Configuration("train_synthetic_stereonet", workspace=workspace, root=root, load_model=load_model,
                            overrides={"model_name": model, "mode": mode, "epoch": 1, "batch_size": 4, "workers": 0,
                                       "use_normal": model == "nnet"})
        cfg.data["dataset"].update(height=hw, width=hw, train_samples=8, test_samples=4)
        cfg.data["crop_aug"]["soft_crop"]["crop_factor"] = crop_factor
        cfg.data["model"].update(over)
        return cfg.get_config()

    opt = option("fit")
    trainer = Trainer(opt, device="cpu")
    trainer.fit()
    agg = trainer.test()
    ws = root / "workspace" / model / "fit"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    ckpts = sorted(p.name for p in (ws / "checkpoints").iterdir())
    restored = Trainer(option("restore", "test", str(ws / "checkpoints" / "checkpoint_00.pt")), device="cpu").test()
    return records, ckpts, agg, restored


def check_fit(records, ckpts, agg, restored, metric_packs) -> None:
    """A finite train record of 2 steps and a test record, one checkpoint,
    the metric packs of the model's config, and the restored trainer's
    tables equal to the first's (rtol 1e-6: the same weights and batches in
    one process). Every table entry is finite but absolute_dp's rmse_log:
    it takes the log of the depths, which a model one epoch from its init
    makes negative somewhere (NaN, as the JAX pack gives; both trainers
    must agree on it)."""
    assert [r["mode"] for r in records] == ["train", "test"]
    assert records[0]["steps"] == 2.0
    assert all(np.isfinite(v) for v in records[0].values() if isinstance(v, float))
    assert ckpts == ["checkpoint_00.pt"]
    assert set(agg) == set(restored) == set(metric_packs)
    for pack, table in agg.items():
        assert set(table) == set(restored[pack])
        for key, v in table.items():
            assert np.isfinite(v) or (pack, key) == ("absolute_dp", "rmse_log"), (pack, key)
            np.testing.assert_allclose(restored[pack][key], v, rtol=1e-6, err_msg=f"{pack}/{key}")
