"""The port's `psmnet` against the JAX package's, on the CPU.

The concat and group-wise correlation volumes over negative, zero and
positive shifts; the eval forward at 64x64, batch 2, inplanes 8, with
either volume; one f32 train step of the committed concat volume (losses,
gradients, batch statistics, updated parameters) from weights carried
across by `weights.state_dict_from_jax`; `Trainer.fit` and `test` on
SyntheticDP with a restore. Shared pieces and the tolerances' reasons:
`tests/torch_zoo.py`.
"""
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu_torch.models import build_model
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

MODEL = "psmnet"
OVER = {"inplanes": 8}
GWC = {**OVER, "cost_volume": "gwcnet", "group_num": 4}
# of views seeds 1, 2 and 3, the first where JAX and the port in f32 take
# every kink alike (at 1 and 3 a few gradients differ by 1e-2, the jump
# of a ReLU or a smooth-L1 branch taken the other way)
VIEWS_SEED = 2


@pytest.mark.parametrize("kind", ["concat", "gwc"])
def test_cost_volume_matches_jax(kind):
    zoo.check_volumes(kind)


@pytest.mark.parametrize("over", [OVER, GWC], ids=["psmnet", "gwcnet"])
def test_eval_matches_jax(over):
    """One head in eval mode; 32 bins at full resolution."""
    ref, got = zoo.eval_pair(MODEL, over)
    zoo.check_eval(ref, got, {"pred_depth": (2, 1, 64, 64), "prob_depth": (2, 1, 32, 64, 64),
                              "ref_feature": (2, 16, 16)})


def test_agg_dpack_is_accepted_and_changes_nothing():
    """`agg_dpack`, the JAX package's relayout of the same aggregation, is
    taken and ignored: the same state_dict keys and the same forward."""
    _, plain = zoo.options(MODEL, OVER)
    _, packed = zoo.options(MODEL, {**OVER, "agg_dpack": "full"})
    a, b = (build_model(opt, device="cpu", seed=3) for opt in (plain, packed))
    assert a.state_dict().keys() == b.state_dict().keys()
    batch = {k: torch.as_tensor(v) for k, v in zoo.views_batch(4, b=1).items()}
    with torch.no_grad():
        assert torch.equal(a(batch)["pred_depth"], b(batch)["pred_depth"])


@pytest.fixture(scope="module")
def steps():
    jstep = zoo.jax_step(MODEL, OVER, VIEWS_SEED)
    return jstep, zoo.port_step(MODEL, *jstep[:3])


def test_train_step_losses_match_jax(steps):
    """The smoothL1 over the three heads, to 1e-5 relative."""
    (_, _, _, ref, _), (_, got) = steps
    assert set(got) == set(ref) == {"smoothL1_loss", "final_loss"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_train_step_gradients_match_jax(steps):
    """Per parameter within 1e-3 of its norm (6.2e-4 the largest measured:
    the largest SPP branch, whose 16x16 pool leaves one pixel a view, so
    its BatchNorm normalises 2 values a channel; the median 1e-5)."""
    jstep, pstep = steps
    errs = zoo.gradient_errors(MODEL, jstep, pstep)
    assert len(errs) == len(list(pstep[0].model.parameters()))
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    assert not bad, bad


def test_train_step_batch_stats_and_update_match_jax(steps):
    """Every BatchNorm's statistics (the tower's updated once per view, as
    JAX's two calls do, the downsample skips' included) and every
    parameter's update (`torch_zoo.update_errors`)."""
    jstep, pstep = steps
    # the tower: 3 + 2 x 13 blocks + 2 skips + 4 branches + 1; the aggregation: 4 + 3 x 6 + 3
    assert zoo.check_batch_stats(MODEL, jstep, pstep) == 2 * (36 + 25)
    errs = zoo.update_errors(MODEL, jstep, pstep)
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    assert not bad, bad


def test_trainer_fits_tests_and_restores_on_the_cpu(tmp_path):
    zoo.check_fit(*zoo.fit_and_restore(tmp_path, MODEL, OVER), ("absolute_dp", "affine_dp"))
