"""The port's folded multi-view loss and its grid sampling against the JAX
package's, on the CPU.

Same numpy inputs through `dualpixelface_tpu.ops.resample` /
`losses.folded` and `dualpixelface_tpu_torch.ops.resample` /
`losses.folded`: `grid_sample` (values and the vjp with respect to the
image and the grid, coordinates out of range included, and against
`F.grid_sample`), `general_robust_loss` at alpha 2, 0, 1, +inf and -inf,
`FoldedLoss`'s value and gradient with respect to `pred_depth` (against
`jax.grad`) with points that project out of the reference views, dpnet's
`config_multi` train step with smoothL1 + folded against JAX's
`make_train_step`, the loss on 2 gloo ranks against one process, and the
multi-view run through the CLI.
Geometry: `profile_train.multiview_keys`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_ranks as ranks
import torch_zoo as zoo
from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.losses import folded as jax_folded
from dualpixelface_tpu.ops.resample import grid_sample as jax_grid_sample
from dualpixelface_tpu_torch import parallel
from dualpixelface_tpu_torch.config import Configuration
from dualpixelface_tpu_torch.data.SyntheticDP.fixture import (MULTIVIEW_LOSSES, MULTIVIEW_RUN, write_fixture_tree,
                                                              write_multiview_run)
from dualpixelface_tpu_torch.losses import available_losses, folded
from dualpixelface_tpu_torch.ops.resample import grid_sample
from torch_cpu_setup import two_threads
from dualpixelface_tpu_torch.profile_train import multiview_keys
from torch_multiview import folded_batch

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent
# the multi-view run's keys (tests/test_multiview.py's, without its size cut)
MULTI, LOSSES = MULTIVIEW_RUN, MULTIVIEW_LOSSES


def multi_options(model_over: dict | None = None):
    """The JAX and the port's merged `train_faceDP_dpnet` with MULTI and
    LOSSES, model keys also from `model_over`."""
    out = []
    for cls in (JaxConfiguration, Configuration):
        cfg = cls("train_faceDP_dpnet", make_workspace=False, overrides=MULTI)
        cfg.data["model"].update(LOSSES, **(model_over or {}))
        out.append(cfg.get_config())
    return out


# ------------------------------------------------------------ grid_sample

@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    """Values and the vjp (image and grid) at coordinates in [-1.3, 1.3],
    some exactly on -1, 1 and at the out-of-view 2.0 of `cam2pixel`: to
    1e-6 of JAX's (the same f32 products and sums in the same order) and
    the values to 1e-5 of `F.grid_sample`'s."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    grid = (rng.random((2, 5, 6, 2)) * 2.6 - 1.3).astype(np.float32)
    grid[0, 0, :3] = [[-1.0, -1.0], [1.0, 1.0], [2.0, 2.0]]
    cot = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)

    want, vjp = jax.vjp(lambda i, g: jax_grid_sample(i, g, align_corners), jnp.asarray(img), jnp.asarray(grid))
    want_img, want_grid = vjp(jnp.asarray(cot))
    ti, tg = torch.tensor(img, requires_grad=True), torch.tensor(grid, requires_grad=True)
    got = grid_sample(ti, tg, align_corners)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_img), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_grid), rtol=1e-5, atol=1e-5)
    assert not got[0, 0, 2].any()  # (2, 2) samples nothing
    ref = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the robust loss

@pytest.mark.parametrize("alpha", [2.0, 0.0, 1.0, np.inf, -np.inf])
def test_general_robust_loss_matches_jax(alpha):
    """Each case of the host-side split, at residuals up to 40 scales
    (where alpha +inf's clamp at 87.5 binds), to 1e-6 relative."""
    x = np.linspace(-4, 4, 41).astype(np.float32)
    want = np.asarray(jax_folded.general_robust_loss(jnp.asarray(x), alpha, 0.1))
    got = folded.general_robust_loss(torch.from_numpy(x), alpha, 0.1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the loss

def test_folded_is_registered():
    assert "folded" in available_losses()


@pytest.mark.parametrize("conf", [False, True])
def test_folded_loss_and_gradient_match_jax(conf):
    """`FoldedLoss` on 2 samples of 12x16 with 3 reference views, ~75%
    of the pixels in the mask, sub-pixel crop offsets, and some points that
    project out of a reference view (a depth of -5: Z clamped at 1e-3;
    and depths whose warp leaves the image): the loss to 1e-6 relative and
    its gradient with respect to pred_depth to 1e-5 of the largest entry
    (f32; the inverses of K and P by LU in both, then the same sums). Every
    out-of-view coordinate gets a zero gradient and none is NaN."""
    jopt, popt = multi_options()
    pred, batch = folded_batch(3, conf=conf)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_grad = jax.value_and_grad(
        lambda p: jax_folded.FoldedLoss(jopt)({"pred_depth": p}, jb)["loss"])(jnp.asarray(pred))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = torch.tensor(pred, requires_grad=True)
    out = folded.FoldedLoss(popt)({"pred_depth": p}, tb)
    out["loss"].backward()
    assert float(out["loss"].detach()) == pytest.approx(float(want), rel=1e-6)
    want_grad = np.asarray(want_grad)
    got_grad = p.grad.numpy()
    assert np.isfinite(got_grad).all()
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())
    np.testing.assert_array_equal(out["abvalue"].numpy(), batch["abvalue"])

    # some points project out of view for a positive depth too
    tar3d = folded.pixel2cam(folded.make_grid(2, 12, 16), tb["K"], p[:, 0].detach(), tb["mask"])
    coords = folded.cam2pixel(tar3d, tb["P"], tb["Ps"][:, 0], tb["Ks"][:, 0], 20, 24)
    outside = (coords == 2.0).any(-1) & (p[:, 0].detach() > 0) & (tb["mask"] > 0)
    assert 0 < int(outside.sum()) < outside.numel() // 2


def test_folded_view_count_comes_from_the_projections():
    """The views taken are the first min(N, num_neighbor_view), N read from
    batch["Ps"] (one of the reference's two bugs, repaired as in JAX): with
    num_neighbor_view 1 the loss is the first view's alone, with 5 the
    mean over the 3 there are."""
    pred, batch = folded_batch(4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    results = {"pred_depth": torch.from_numpy(pred)}

    def loss(views, cut=None):
        popt = multi_options({"num_neighbor_view": views})[1]
        b = tb if cut is None else {**tb, "Ps": tb["Ps"][:, cut], "Ks": tb["Ks"][:, cut],
                                    "centers": tb["centers"][:, cut]}
        return float(folded.FoldedLoss(popt)(results, b)["loss"])

    singles = [loss(1, slice(i, i + 1)) for i in range(3)]
    assert loss(1) == pytest.approx(singles[0], rel=1e-6)
    assert loss(5) == pytest.approx(sum(singles) / 3, rel=1e-6)


# ------------------------------------------------------------ dpnet's multi-view step

# dpnet's heads land on the full resolution at multiples of 96; views seed 5
# and PReLU slopes U(0.85, 0.95): test_torch_dpnet.py
MODEL = "dpnet"
VIEWS_SEED = 5
# The folded loss takes the first head as a depth. At the refill's weights
# it spans -5..7: the points of depth near 0+ that still land in a
# reference view move by f t / d^2 pixels per unit of depth (~1e3 at 0.03),
# so the 1e-5 by which the two packages' f32 predictions differ moves their
# samples across pixel boundaries, and the step's gradient then differs
# from f64's by 4.5% in JAX, 0.7% in the port, and the parameters' by up to
# 100%. Here the first head's last BatchNorm bias is raised by HEAD_SHIFT
# (its depths ~5..15, all positive) and the references move by up to
# 0.08 x 10 in x (~10 pixels at depth 5): at geometry seeds 0-3 every
# parameter's gradient lies within 1e-3 of JAX's (the largest 8.5e-4,
# 2.5e-4, 3.3e-4, 6.7e-4); seed 1 is held.
HEAD_SHIFT = 10.0
GEOMETRY_SEED = 1


def positive_first_head(variables, option):
    from test_torch_dpnet import prelu_slopes_near_one

    variables = prelu_slopes_near_one(variables, option)
    bn = variables["params"]["conv_last_layer1"]["BatchNorm_0"]
    bn["bias"] = bn["bias"] + np.float32(HEAD_SHIFT)
    return variables


def _multiview_extension(batch_np: dict) -> dict:
    b, h, w = batch_np["depth"].shape
    return multiview_keys(np.random.default_rng(GEOMETRY_SEED), b, h, w, depth=HEAD_SHIFT)


@pytest.fixture(scope="module")
def multi_steps():
    jstep = zoo.jax_step(MODEL, LOSSES, VIEWS_SEED, adjust=positive_first_head, run_over=MULTI,
                         extend=_multiview_extension)
    return jstep, zoo.port_step(MODEL, *jstep[:3])


def test_multiview_step_losses_match_jax(multi_steps):
    """smoothL1, folded and final to 1e-5 relative; folded non-zero."""
    (_, _, _, ref, _), (_, got) = multi_steps
    assert set(got) == set(ref) == {"smoothL1_loss", "folded_loss", "final_loss"}
    assert ref["folded_loss"] > 0
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_multiview_step_gradients_match_jax(multi_steps):
    """Each parameter's gradient within 1e-3 of its norm, as
    test_torch_dpnet.py holds the single-view step; a gradient that JAX
    gives as exactly 0 (the first head's PReLU slope: its inputs are all
    positive) exactly 0 in the port; and every BatchNorm's statistics
    (`torch_zoo.check_batch_stats`)."""
    jstep, pstep = multi_steps
    _, init, _, _, after = jstep
    ref = zoo.port_weights(MODEL, {"params": after["grads"], "batch_stats": init["batch_stats"]})
    zero = sorted(n for n, g in ref.items() if n.endswith(("weight", "bias")) and not np.any(g))
    assert zero == ["conv_last_layer1.prelu.weight"], zero
    grads = dict(pstep[0].model.named_parameters())
    for name in zero:
        assert not grads[name].grad.any(), name
    with np.errstate(invalid="ignore"):
        errs = {k: v for k, v in zoo.gradient_errors(MODEL, jstep, pstep).items() if k not in zero}
    assert len(errs) + len(zero) == len(grads)
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    assert not bad, bad
    assert zoo.check_batch_stats(MODEL, jstep, pstep) == 2 * 82


# ------------------------------------------------------------ two ranks

def test_folded_on_two_ranks_is_one_process(tmp_path):
    """Batch 4 (2 rows a rank, the masks' counts differing): each rank's
    loss is one process's on the whole batch (1e-6), and each rank's rows
    get twice one process's gradient (each rank's loss is the global one;
    the step then averages the parameters' gradients over the 2 ranks), to
    1e-6 of its largest entry."""
    pred, batch = folded_batch(6, b=4)
    batch["mask"][:2] *= np.random.default_rng(0).uniform(size=batch["mask"][:2].shape) < 0.5
    got = parallel.spawn(ranks.folded_rank, 2, "cpu", args=({"pred": pred, **batch},),
                         init_method=f"file://{tmp_path / 'rendezvous'}")
    ref = ranks.folded_rank({"pred": pred, **batch})  # this process is one rank of one
    for g in got:
        assert g["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    grad = np.concatenate([g["grad"] for g in got]) / 2
    np.testing.assert_allclose(grad, ref["grad"], rtol=0, atol=1e-6 * np.abs(ref["grad"]).max())


# ------------------------------------------------------------ the run, through the CLI

def test_multiview_run_through_the_cli_on_the_cpu(tmp_path):
    """The multi-view run (`fixture.write_multiview_run`: train_faceDP_dpnet
    with config_multi, use_multi, use_raw, views 1-3, the references'
    centre images, smoothL1 + folded) through `python -m
    dualpixelface_tpu_torch.main --device cpu` on a FaceDP fixture of
    128x128 samples (1 train view and 1 test view, 3 cameras each; the
    committed soft crop gives 96x96), one epoch, 2 DataLoader workers: a
    train record of 1 step with a finite, non-zero folded loss, a test
    record, the epoch's checkpoint."""
    fixture = write_fixture_tree(tmp_path / "rcv", n_train=1, n_test=1, height=128, width=128, cams=(1, 2, 3))
    config = write_multiview_run(tmp_path, fixture, overrides={"epoch": 1, "workers": 2})
    code = ("import runpy, sys\n"
            "import dualpixelface_tpu_torch.config.manager as m\n"
            f"m.REPO_ROOT = m.Path({str(tmp_path)!r})\n"
            f"sys.argv = ['main', '--config', {str(config)!r}, '--workspace', 'cli', '--device', 'cpu']\n"
            "runpy.run_module('dualpixelface_tpu_torch.main', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ws = tmp_path / "workspace" / "dpnet" / "cli"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in records] == ["train", "test"]
    train = records[0]
    assert train["steps"] == 1.0 and np.isfinite(train["final_loss"])
    assert np.isfinite(train["folded_loss"]) and train["folded_loss"] > 0
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == ["checkpoint_00.pt"]
