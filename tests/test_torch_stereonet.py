"""The port's `stereonet` against the JAX package's, on the CPU.

The subtraction volume over negative, zero and positive shifts; the eval
forward at 64x64, batch 2; one f32 train step (losses, gradients, batch
statistics, updated parameters) from weights carried across by
`weights.state_dict_from_jax`; `Trainer.fit` and `test` on SyntheticDP with
a restore; the `ci_smoke` run config through the port's CLI on the CPU;
and that an f32 trainer or predictor runs exact f32 (no TF32). Shared
pieces and the tolerances' reasons: `tests/torch_zoo.py`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu_torch.config import Configuration, load_config
from dualpixelface_tpu_torch.serve import Predictor
from dualpixelface_tpu_torch.train.trainer import Trainer
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

MODEL = "stereonet"
# conv3d_alone's bias adds one constant to every plane's logit, which the
# soft-argmin cancels; the tower's last bias cancels in ref - target on the
# valid rows (the rest are masked): both have exact gradient zero
ZERO_GRAD = ("conv3d_alone.bias", "feature_extraction.lastconv.bias")
VIEWS_SEED = 2


def test_subtraction_volume_matches_jax():
    zoo.check_volumes("subtraction")


def test_eval_matches_jax():
    """k = 3: eight planes at 8x8; pred_depth the coarse and the refined
    (1.9e-4 the largest difference measured: the refinement returns
    relu(8 d + r) of the low-resolution disparity d times a literal 8, and
    where 8 d and r near -8 d are ~25 each, a result near 0 keeps their
    rounding)."""
    ref, got = zoo.eval_pair(MODEL, {})
    zoo.check_eval(ref, got, {"pred_depth": (2, 2, 64, 64), "prob_depth": (2, 1, 8, 8, 8),
                              "ref_feature": (2, 8, 8)})


@pytest.fixture(scope="module")
def steps():
    jstep = zoo.jax_step(MODEL, {}, VIEWS_SEED)
    return jstep, zoo.port_step(MODEL, *jstep[:3])


def test_train_step_losses_match_jax(steps):
    """The smoothL1 over both heads, to 1e-5 relative."""
    (_, _, _, ref, _), (_, got) = steps
    assert set(got) == set(ref) == {"smoothL1_loss", "final_loss"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_train_step_gradients_match_jax(steps):
    """Per parameter within 1e-3 of its norm (6.0e-4 the largest measured,
    the refinement's convs, median 2.4e-5): at this point JAX's f32
    gradient and the port's each differ from the port's in f64 by up to
    5.4e-4 there, so that is f32's own noise; the two zero-gradient biases
    within 1e-5 of their weight's gradient norm."""
    jstep, pstep = steps
    errs = zoo.gradient_errors(MODEL, jstep, pstep, ZERO_GRAD)
    assert len(errs) == len(list(pstep[0].model.parameters()))
    bad = {k: v for k, v in errs.items() if not v <= (1e-5 if k in ZERO_GRAD else 1e-3)}
    assert not bad, bad


def test_train_step_batch_stats_and_update_match_jax(steps):
    """The 2 x (6 + 1) 2-D and 4 3-D BatchNorms' statistics (the tower's
    updated once per view, as JAX's two calls do), and every parameter's
    update (`torch_zoo.update_errors`)."""
    jstep, pstep = steps
    assert zoo.check_batch_stats(MODEL, jstep, pstep) == 2 * 17
    errs = zoo.update_errors(MODEL, jstep, pstep, ZERO_GRAD)
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    assert not bad, bad


def test_trainer_fits_tests_and_restores_on_the_cpu(tmp_path):
    zoo.check_fit(*zoo.fit_and_restore(tmp_path, MODEL, {}), ("absolute_dp", "affine_dp"))


def test_ci_smoke_through_the_cli_on_the_cpu(tmp_path):
    """`python -m dualpixelface_tpu_torch.main --config <ci_smoke> --device
    cpu`: the committed run config (stereonet, batch 4, 2 workers, f32),
    its dataset cut to SyntheticDP at 48x48 (32x32 crops), 4 train and 3
    test samples, through files beside a temporary copy: rc 0, a train
    record of one step and a test record, finite, and the checkpoint."""
    data = json.loads((zoo.REPO / "dualpixelface_tpu_torch" / "data" / "SyntheticDP" / "config.json").read_text())
    data.update(height=48, width=48, train_samples=4, test_samples=3)
    (tmp_path / "tiny_data.json").write_text(json.dumps(data))
    aug = json.loads((zoo.REPO / "dualpixelface_tpu_torch" / "data" / "preprocess" / "config_train.json").read_text())
    aug["crop_aug"]["soft_crop"]["crop_factor"] = 32
    (tmp_path / "tiny_aug.json").write_text(json.dumps(aug))
    run = json.loads((zoo.REPO / "configs" / "ci_smoke.json").read_text())
    assert run["model_name"] == MODEL
    run.update(dataset_config=str(tmp_path / "tiny_data"), augmentation_config=str(tmp_path / "tiny_aug"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "ci_smoke.json").write_text(json.dumps(run))
    code = ("import runpy, sys\n"
            "import dualpixelface_tpu_torch.config.manager as m\n"
            f"m.REPO_ROOT = m.Path({str(tmp_path)!r})\n"
            "sys.argv = ['main', '--config', 'ci_smoke', '--workspace', 'ci', '--device', 'cpu']\n"
            "runpy.run_module('dualpixelface_tpu_torch.main', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(zoo.REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ws = tmp_path / "workspace" / MODEL / "ci"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in records] == ["train", "test"]
    assert records[0]["steps"] == 1.0 and np.isfinite(records[0]["final_loss"])
    # every entry but rmse_log (`torch_zoo.check_fit` says why)
    assert all(np.isfinite(v) for k, v in records[1].items() if isinstance(v, float) and k != "absolute_dp/rmse_log")
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == ["checkpoint_00.pt"]


def test_f32_runs_turn_tf32_off(tmp_path):
    """An f32 Trainer and an f32 Predictor turn both TF32 flags off (for
    the process); a bf16 Predictor leaves them as they were."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    cfg = Configuration("ci_smoke", make_workspace=False).get_config()
    try:
        for make in (lambda: Trainer(cfg, device="cpu"),
                     lambda: Predictor(load_config(MODEL), device="cpu", dtype=torch.float32)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            make()
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (False, False)
        for flags in ((True, True), (True, False)):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            Predictor(load_config(MODEL), device="cpu", dtype=torch.bfloat16)
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
