"""The PyTorch port's trainer, checkpoints and CLI against the JAX package's, on the CPU.

One 2-step epoch of `Trainer.fit` (stereodpnet_plus, f32, Adam, SyntheticDP
at a 32x32 crop, batch 1) logs the JAX `Trainer.fit`'s losses from the same
weights (the committed plateau checkpoint, through `state_dict_from_jax`)
and saves the parameters and batch statistics of the JAX trainer's state
after its 2 steps, and both
trainers' `test()` from those weights at a 96x96 crop (3 samples, batch 2:
the last batch padded) give the same metric aggregates within BASELINE.md's
0.5%. The JAX trainer gets the weights by its `init_state` (the state it
would build on its first batch). Then the port's own: a checkpoint's round
trip, strict and partial restore, `auto_resume`, the refusal of files that
are no checkpoint of the port, the demo figures, the CLI on the CPU, and
the refusal to run without a card unless the CPU is asked for.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.train.optim import optimizer_selector as jax_optimizer_selector
from dualpixelface_tpu.train.state import TrainState as JaxTrainState
from dualpixelface_tpu.train.trainer import Trainer as JaxTrainer
from dualpixelface_tpu_torch.config import Configuration
from dualpixelface_tpu_torch.train.checkpoint import load_checkpoint, restore_checkpoint
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.trainer import Trainer
from dualpixelface_tpu_torch.utils.profiling import timeit
from dualpixelface_tpu_torch.weights import state_dict_from_jax
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent
PLATEAU = REPO / "tests" / "data" / "serving_plateau_192.msgpack"
NAME = "train_synthetic_stereodpnet_plus"
# the dataset sizes of each run: 48x48 images give 32x32 crops (config_train:
# ratio 0.75, crop_factor 32); 96x96 ones 96x96 (config_test: ratio 1.0)
FIT_DATA = {"height": 48, "width": 48, "train_samples": 2, "test_samples": 3}
# the fit runs batch 1: 2 steps, the second from the first's update
FIT_OVER = {"batch_size": 1}
TEST_DATA = {"height": 96, "width": 96, "train_samples": 2, "test_samples": 3}


@pytest.fixture(scope="module")
def plateau():
    """The committed plateau checkpoint's variables and their port state_dict."""
    variables = flax.serialization.msgpack_restore(PLATEAU.read_bytes())
    return variables, state_dict_from_jax(variables["params"], variables["batch_stats"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root holding a copy of configs/, for both packages' workspaces."""
    r = tmp_path_factory.mktemp("root")
    shutil.copytree(REPO / "configs", r / "configs")
    return r


def _configure(cls, root, workspace, dataset, overrides=None, load_model=None):
    cfg = cls(NAME, workspace=workspace, root=root, load_model=load_model,
              overrides={"epoch": 1, "batch_size": 2, "workers": 0, **(overrides or {})})
    cfg.data["dataset"].update(dataset)
    cfg.data["crop_aug"]["soft_crop"]["crop_factor"] = 32
    return cfg.get_config()


def _jax_trainer(opt, variables):
    """The JAX trainer with `variables` as the state its init_state builds."""
    trainer = JaxTrainer(opt)

    def init_state(sample_batch=None, steps_per_epoch=1):
        trainer.state = JaxTrainState.create(
            apply_fn=trainer.model.apply, params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
            tx=jax_optimizer_selector(opt, steps_per_epoch))
        return trainer.state

    trainer.init_state = init_state
    return trainer


def _records(opt, mode):
    lines = (Path(opt.output_path) / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["mode"] == mode]


@pytest.fixture(scope="module")
def fitted(root, plateau):
    """One 2-step epoch of each trainer from the plateau weights; the JAX
    trainer's variables after it, and the port's trainer, with both
    configs."""
    variables, sd = plateau
    jopt = _configure(JaxConfiguration, root, "jax_fit", FIT_DATA, FIT_OVER)
    jstate = _jax_trainer(jopt, variables).fit()
    after = jax.tree_util.tree_map(np.array, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    opt = _configure(Configuration, root, "port_fit", FIT_DATA, FIT_OVER)
    trainer = Trainer(opt, device="cpu", state_dict=sd)
    trainer.fit()
    return jopt, opt, trainer, after


def test_fit_losses_match_jax(fitted):
    """The epoch's record: the losses (the mean of the 2 steps', the second
    taken after the first update) at the whole-step tolerance of
    tests/test_torch_train.py (1e-4 relative), and the same epoch, steps,
    learning rate and checkpoint name."""
    jopt, opt, _, _ = fitted
    (ref,), (got,) = _records(jopt, "train"), _records(opt, "train")
    assert set(got) == set(ref)
    for key in ("smoothL1_loss", "cosine_loss", "final_loss"):
        assert got[key] == pytest.approx(ref[key], rel=1e-4), key
    assert {k: got[k] for k in ("epoch", "steps", "lr")} == {k: ref[k] for k in ("epoch", "steps", "lr")} \
        == {"epoch": 0.0, "steps": 2.0, "lr": 1e-4}
    assert [p.name for p in Path(jopt.ckpt_path).iterdir()] == ["checkpoint_00"]
    assert [p.name for p in Path(opt.ckpt_path).iterdir()] == ["checkpoint_00.pt"]


# The two deform convs' biases feed batch-statistics BatchNorms, so their
# exact gradient is zero (tests/test_torch_train.py's ZERO_GRAD).
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def test_fit_checkpoint_matches_jax_state(fitted, plateau):
    """The port's saved checkpoint against the JAX trainer's state after
    the same 2 steps: the trainer's wiring (the state carried from step to
    step, the optimizer and its schedule, what the checkpoint saves).

    Batch statistics within tests/test_torch_train.py's 1e-4 relative
    (1e-6 absolute; 0.14 of that bound measured), and the two
    zero-gradient biases' moves within its 1e-7 absolute (0.34 of it).
    The parameters' moves from the plateau weights: the whole update
    within 2e-2 of the JAX update's norm, and each parameter's within 0.1
    of its own. Not test_torch_train's 1e-3 per parameter: that test holds
    one step at a views seed chosen free of kink flips, and SyntheticDP's
    second step here is not free of them (a BatchNorm bias channel of
    aggregation.dres1 moved 1.8% off JAX's, 1.4e-3 of its parameter's
    update, on 2 threads; on 1 thread the whole update is 5.6e-3 off and
    the worst parameter 2.8e-2). The wiring faults stand far above those
    bounds (each made in a copy): the second update dropped or taken twice
    puts the whole update 0.47 and 0.40 off, a parameter left out of the
    optimizer is 1.0 off its own move."""
    _, opt, _, after = fitted
    variables, _ = plateau
    ref = state_dict_from_jax(after["params"], after["batch_stats"])
    before = state_dict_from_jax(variables["params"], variables["batch_stats"])
    saved = load_checkpoint(Path(opt.ckpt_path) / "checkpoint_00.pt")
    assert saved["step"] == 2
    sd = {k: v.numpy() for k, v in saved["model"].items()}
    assert set(ref) <= set(sd)
    for name in ref:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name], ref[name], rtol=1e-4, atol=1e-6, err_msg=name)
    bad, diff, norm = {}, 0.0, 0.0
    for name in saved["param_names"]:
        d_got, d_ref = sd[name] - before[name], ref[name] - before[name]
        if name in ZERO_GRAD:
            err = max(np.abs(d_got).max(), np.abs(d_ref).max()) / 1e-7
        else:
            diff += float(np.square(d_got - d_ref).sum())
            norm += float(np.square(d_ref).sum())
            err = np.linalg.norm(d_got - d_ref) / np.linalg.norm(d_ref) / 0.1
        if not err <= 1.0:
            bad[name] = float(err)
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]
    assert (diff / norm) ** 0.5 <= 2e-2


# the keys held to BASELINE.md's 0.5% (tests/test_torch_stereodpnet.py's
# rule: depth RMSE, the normals' mean angle, and 1 - Spearman, a rank
# statistic that float noise regroups on tied predictions)
BUDGET = {("absolute_dp", "rmse"), ("normal_dp", "mean_angle_deg"), ("affine_dp", "spearman")}


def test_test_metrics_match_jax(root, plateau):
    """`test()` of both trainers from the plateau weights, 96x96, 3 samples
    in batches of 2 (the padded row left out of the metrics), over the same
    3 samples: the BUDGET keys within BASELINE.md's 0.5% relative, every
    other aggregate within 1e-4 of max(1, |JAX's|)."""
    variables, sd = plateau
    over = {"mode": "test", "augmentation_config": "config_test"}
    jopt = _configure(JaxConfiguration, root, "jax_test", TEST_DATA, over)
    jtrainer = _jax_trainer(jopt, variables)
    jtrainer.init_state()
    ref = jtrainer.test()
    got = Trainer(_configure(Configuration, root, "port_test", TEST_DATA, over), device="cpu", state_dict=sd).test()
    assert set(got) == set(ref) == {"absolute_dp", "affine_dp", "normal_dp"}
    for pack, values in ref.items():
        assert set(got[pack]) == set(values)
        for key, r in values.items():
            tol = 5e-3 if (pack, key) in BUDGET else 1e-4
            assert abs(got[pack][key] - r) <= tol * max(1.0, abs(r)), (pack, key, got[pack][key], r)
    bench = Trainer(_configure(Configuration, root, "port_test", TEST_DATA, over), device="cpu", state_dict=sd)
    bench.test()
    assert [b.index for b in bench.metric_bank.benchmarks] == [2, 2, 2]  # 2 batches, the padded row dropped


def test_checkpoint_round_trip(fitted, root):
    """A restored checkpoint gives the saved state_dict, optimizer state
    and step bit for bit, and a test-only run restoring it (the
    --load_model path) the same metrics as the trainer that saved it."""
    _, opt, trainer, _ = fitted
    path = Path(opt.ckpt_path) / "checkpoint_00.pt"
    state = create_train_state(opt, 1, device="cpu", seed=5)
    restore_checkpoint(path, state, strict=True)
    assert state.step == trainer.state.step == 2
    saved, now = trainer.state.model.state_dict(), state.model.state_dict()
    assert list(saved) == list(now)
    for k in saved:
        assert torch.equal(saved[k], now[k]), k
    a, b = trainer.state.optimizer.state_dict(), state.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"] and a["state"].keys() == b["state"].keys()
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k]), (i, k)
    agg = trainer.test()
    restored = Trainer(_configure(Configuration, root, "port_fit", FIT_DATA, {**FIT_OVER, "mode": "test"},
                                  load_model=str(path)), device="cpu")
    assert restored.test() == agg


def test_partial_restore_keeps_mismatched_entries(fitted, tmp_path):
    """load_strict false: an entry of another shape and a missing one keep
    their current values (model and optimizer), the rest is restored;
    strict, the same checkpoint raises."""
    _, opt, trainer, _ = fitted
    payload = load_checkpoint(Path(opt.ckpt_path) / "checkpoint_00.pt")
    names = payload["param_names"]
    wrong, gone = "feature_extraction.firstconv.0.0.weight", names[-1]
    assert wrong in payload["model"] and gone in payload["model"]
    payload["model"][wrong] = torch.zeros(3)
    del payload["model"][gone]
    payload["optimizer"]["state"][names.index(wrong)]["exp_avg"] = torch.zeros(3)
    bad = tmp_path / "checkpoint_07.pt"
    torch.save(payload, bad)
    state = create_train_state(opt, 1, device="cpu", seed=5)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(RuntimeError):
        restore_checkpoint(bad, state, strict=True)
    state = create_train_state(opt, 1, device="cpu", seed=5)
    restore_checkpoint(bad, state, strict=False)
    after, saved = state.model.state_dict(), trainer.state.model.state_dict()
    for k in after:
        assert torch.equal(after[k], before[k] if k in (wrong, gone) else saved[k]), k
    opt_state = state.optimizer.state_dict()["state"]
    assert names.index(wrong) not in opt_state and len(opt_state) == len(names) - 1
    assert state.step == 2


def test_auto_resume_continues_after_epoch_0(fitted, root):
    """A trainer with auto_resume in the same workspace and 2 epochs runs
    epoch 1 only, from the epoch-0 checkpoint, and saves epoch 1's."""
    _, opt, _, _ = fitted
    trainer = Trainer(_configure(Configuration, root, "port_fit", FIT_DATA,
                                 {**FIT_OVER, "epoch": 2, "auto_resume": True}), device="cpu")
    assert trainer.latest_checkpoint() == (str(Path(opt.ckpt_path) / "checkpoint_00.pt"), 0)
    state = trainer.fit()
    assert state.step == 4
    assert trainer.latest_checkpoint()[1] == 1
    assert sorted(p.name for p in Path(opt.ckpt_path).iterdir()) == ["checkpoint_00.pt", "checkpoint_01.pt"]
    resume = _records(opt, "resume")[-1]
    assert resume["epoch"] == 1.0 and resume["checkpoint"].endswith("checkpoint_00.pt")
    assert [r["epoch"] for r in _records(opt, "train")][-1] == 1.0
    os.remove(Path(opt.ckpt_path) / "checkpoint_01.pt")


def test_refuses_files_that_are_no_checkpoint(fitted, tmp_path):
    _, opt, _, _ = fitted
    state = create_train_state(opt, 1, device="cpu", seed=5)
    orbax_like = tmp_path / "checkpoint_00"
    orbax_like.mkdir()
    other = tmp_path / "other.pt"
    torch.save({"weights": torch.zeros(2)}, other)
    for path, match in ((PLATEAU, "not a torch checkpoint"), (orbax_like, "not a torch checkpoint"),
                        (other, "not a checkpoint"), (tmp_path / "missing.pt", "not found")):
        with pytest.raises(RuntimeError, match=match):
            restore_checkpoint(path, state)


def test_demo_mode_saves_figures(root, plateau):
    _, sd = plateau
    opt = _configure(Configuration, root, "port_demo", FIT_DATA, {"mode": "demo", "augmentation_config": "config_test"})
    Trainer(opt, device="cpu", state_dict=sd).test()
    figs = sorted(p.name for p in (Path(opt.output_path) / "figs").iterdir())
    assert figs == ["demo_e000_s000000_0.png", "demo_e000_s000000_1.png", "demo_e000_s000001_0.png"]


def _tiny_run_config(tmp_path) -> Path:
    """A run config whose dataset and augmentation layers are files beside
    it (absolute `dataset_config` / `augmentation_config`, as both
    packages resolve them): SyntheticDP at 48x48, 2 train and 3 test
    samples, 32x32 crops, one epoch of batch 2 on 2 workers."""
    data = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "SyntheticDP" / "config.json").read_text())
    (tmp_path / "tiny_data.json").write_text(json.dumps({**data, **FIT_DATA}))
    aug = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "preprocess" / "config_train.json").read_text())
    aug["crop_aug"]["soft_crop"]["crop_factor"] = 32
    (tmp_path / "tiny_aug.json").write_text(json.dumps(aug))
    run = json.loads((REPO / "configs" / f"{NAME}.json").read_text())
    run.update(epoch=1, batch_size=2, workers=2, dataset_config=str(tmp_path / "tiny_data"),
               augmentation_config=str(tmp_path / "tiny_aug"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(run))
    return tmp_path / "configs" / "tiny.json"


def _cli(tmp_path, *args):
    """`python -m dualpixelface_tpu_torch.main ARGS` in a subprocess, with
    the workspace root moved to tmp_path."""
    code = ("import runpy, sys\n"
            "import dualpixelface_tpu_torch.config.manager as m\n"
            f"m.REPO_ROOT = m.Path({str(tmp_path)!r})\n"
            f"sys.argv = ['main'] + {list(args)!r}\n"
            "runpy.run_module('dualpixelface_tpu_torch.main', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_trains_and_tests_on_the_cpu(tmp_path):
    """The CLI with --device cpu and --profile on a tiny run config: rc 0,
    a train and a test record, the epoch's checkpoint, the profiler's trace
    holding the program's spans and the tracer's counters, all under the
    workspace."""
    config = _tiny_run_config(tmp_path)
    out = _cli(tmp_path, "--config", str(config), "--workspace", "cli", "--device", "cpu", "--profile")
    assert out.returncode == 0, out.stderr[-3000:]
    ws = tmp_path / "workspace" / "stereodpnet_plus" / "cli"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in records] == ["train", "test"]
    assert np.isfinite(records[0]["final_loss"]) and records[0]["steps"] == 1.0
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == ["checkpoint_00.pt"]
    assert '"mode": "test"' in out.stdout and (ws / "output" / "log_text.txt").is_file()
    # --profile: the run's torch.profiler trace and the tracer's file in the log directory
    logs = [p for p in (ws / "log").iterdir() if "tfevents" not in p.name and p.name != "tracer.json"]
    assert [p.name.endswith(".pt.trace.json") for p in logs] == [True]
    assert '"name": "train.step"' in logs[0].read_text()  # the program's spans as ranges
    tracer = json.loads((ws / "log" / "tracer.json").read_text())
    assert tracer["counters"]["h2d.copies"] > 0 and tracer["spans"]["fit.step"]["untimed"] == 1


def test_timeit_is_the_mean_seconds_per_call():
    calls = []
    assert timeit(lambda: calls.append(time.sleep(0.01)), warmup=1, iters=3) >= 0.01
    assert len(calls) == 4


def test_refuses_to_run_without_cuda(tmp_path, root):
    """Without a card and without an explicit CPU request, the Trainer and
    the CLI raise, and the CLI makes no workspace."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_configure(Configuration, root, "port_nocuda", FIT_DATA))
    out = _cli(tmp_path, "--config", NAME, "--workspace", "nocuda")
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (tmp_path / "workspace").exists()
