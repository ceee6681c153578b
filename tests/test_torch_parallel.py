"""Data parallelism of the PyTorch port across processes, on the CPU.

Two gloo ranks through `parallel.spawn` (initialised through a file under
tmp_path, so parallel test workers never share a port), each starting
through `torch_cpu_setup.two_threads` (the rank functions are in
`tests/torch_parallel_ranks.py`, which imports no JAX). A W-rank run at
global batch B must be the one-process run at batch B:

  * the pipeline's rank shards: each rank takes the one-process step count
    and the rows in rank order are the one-process batch, `_valid` too;
  * the BatchNorm's statistics over the global batch at a local batch of
    1, with the gradient through them;
  * one stereodpnet_plus train step at 32x32 of global batch 2 (1 a rank)
    whose halves' masks hold different valid counts: the one-process step
    and JAX's `make_train_step` on the global batch, both ranks bit for bit
    alike after it;
  * `Trainer.fit`, `test()` and `auto_resume` on 2 ranks: rank 0 alone
    writes, and the test tables are the one-process ones;
  * the CLI under `torch.distributed.run` with `--device cpu`.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.losses import loss_selector as jax_loss_selector
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu.train.optim import optimizer_selector as jax_optimizer_selector
from dualpixelface_tpu.train.state import TrainState as JaxTrainState
from dualpixelface_tpu.train.steps import make_train_step as jax_make_train_step
from dualpixelface_tpu_torch import parallel
from dualpixelface_tpu_torch.data.pipeline import DataPipeline, EpochBatches
from dualpixelface_tpu_torch.profile_train import smooth_views, train_batch
from dualpixelface_tpu_torch.train.checkpoint import load_checkpoint
from dualpixelface_tpu_torch.train.trainer import Trainer
from dualpixelface_tpu_torch.weights import state_dict_from_jax
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent


def _spawn(tmp_path, fn, *args, world_size=2):
    return parallel.spawn(fn, world_size, "cpu", args=args, init_method=f"file://{tmp_path / 'rendezvous'}")


# ------------------------------------------------------------ the shards

class _Rows:
    """A dataset whose sample i is its index and one draw of its rng."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng):
        return {"index": np.int64(index), "draw": rng.integers(1 << 30)}


def _batches(n, world_size, rank, training, epoch):
    pipe = DataPipeline(_Rows(n), batch_size=4, shuffle=training, seed=1, drop_last=training,
                        rank=rank, world_size=world_size)
    pipe.set_epoch(epoch)
    return len(pipe), list(pipe)


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("world_size", [1, 2, 4])
@pytest.mark.parametrize("n", [8, 9, 11])
def test_rank_shards_are_the_global_batch(n, world_size, training):
    """Global batch 4 over W ranks, epochs 0 and 1: every rank has the
    one-process step count, and its rows in rank order are the one-process
    batch (indices, the samples' draws, `_valid`): the padded last test
    batch splits as it stands, a rank past its real rows holding padding
    only."""
    for epoch in (0, 1):
        count, ref = _batches(n, 1, 0, training, epoch)
        assert count == len(ref) == (n // 4 if training else -(-n // 4))
        shards = [_batches(n, world_size, r, training, epoch) for r in range(world_size)]
        assert all(c == count and len(b) == count for c, b in shards)
        for i, want in enumerate(ref):
            for key in ("index", "draw", "_valid"):
                got = torch.cat([b[i][key] for _, b in shards])
                assert torch.equal(got, want[key]), (epoch, i, key)
            assert all(len(b[i]["index"]) == 4 // world_size for _, b in shards)
    if not training and n % 4:
        assert ref[-1]["_valid"].tolist() == [True] * (n % 4) + [False] * (4 - n % 4)


def test_batch_must_divide_over_the_ranks():
    with pytest.raises(ValueError, match="no multiple"):
        EpochBatches(9, 4, False, 1, False, rank=0, world_size=3)


# ------------------------------------------------------------ BatchNorm

def _close(got, ref, rel):
    """||got - ref|| <= rel ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref)) <= rel * float(np.linalg.norm(ref))


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (2, 4, 3, 5, 6)], ids=["2d", "3d"])
def test_batchnorm_statistics_are_the_global_batch(tmp_path, shape):
    """Local batch 1 on each of 2 ranks, their rows drawn about different
    means and scales (so per-rank statistics would be far off), two train
    calls (each updates the running statistics): the output, the running
    statistics and the input's gradient of sum(y * w) equal one process on
    the concatenated batch, and the mean over the ranks of the affine
    parameters' gradients is the one-process gradient over 2. Each to 1e-6
    of its norm: the ranks sum the moments in another order than one
    process (f32)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    x[1] = 3.0 + 2.0 * x[1]
    w = rng.standard_normal(shape).astype(np.float32)
    got = _spawn(tmp_path, ranks.batchnorm_rank, x, w, 2)
    ref = ranks.batchnorm_rank(x, w, 2)  # this process is one rank of one
    for key in ("y", "x_grad"):
        assert _close(np.concatenate([g[key] for g in got]), ref[key], 1e-6), key
    for g in got:
        for key in ("running_mean", "running_var"):
            assert _close(g[key], ref[key], 1e-6), key
        for key in ("weight_grad", "bias_grad"):
            assert _close(2 * g[key], ref[key], 1e-6), key


def test_silog_is_the_global_batchs(tmp_path):
    """silog is not linear in its masked means, so each rank takes the
    global batch's (`losses.common.global_masked_means`): with rank 0's
    mask holding 60% of its pixels and rank 1's all of them, each rank's
    loss is one process's on the concatenated batch (1e-6), and each
    rank's rows get twice one process's gradient (the step's ranks each
    report the global loss, and their parameters' gradients are averaged
    over the 2 ranks), to 1e-5 of its norm."""
    rng = np.random.default_rng(11)
    shape = (2, 12, 10)
    mask = np.ones(shape, np.float32)
    mask[0] = rng.uniform(size=shape[1:]) < 0.6
    depth = rng.uniform(800, 1200, shape).astype(np.float32)
    batch = {"pred": rng.uniform(700, 1500, (2, 1) + shape[1:]).astype(np.float32), "depth": depth * mask,
             "mask": mask, "idepth": (1000 / depth).astype(np.float32),
             "abvalue": np.tile(np.float32([[32.98, -26996.49]]), (2, 1))}
    got = _spawn(tmp_path, ranks.silog_rank, batch)
    ref = ranks.silog_rank(batch)  # this process is one rank of one
    for g in got:
        assert g["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    assert _close(np.concatenate([g["grad"] for g in got]) / 2, ref["grad"], 1e-5)


# ------------------------------------------------------------ the step

HW = 32
# The views seed of the step (tests/test_torch_train.py's smooth views at
# the plateau checkpoint, where the f32 gradient is a continuous function
# of rounding unless a kink's input lies within rounding of its switch
# point). At seed 1004, test_torch_train's, the ReLU after classif2's
# BatchNorm holds such an input: the ranks' batch-1 convolutions round it
# to the other side than one process's batch-2 ones, and every gradient
# upstream of classif2 moves (the first tower conv's by ~4e-3 of its
# norm), while the forward activations agree, and with the model in f64
# the gradients do too. Seeds 1008 and 1009, the next of that test's list,
# take the same side of every kink in both runs; 1008 flips a tower PReLU
# against JAX (1.8e-3 of its gradient), 1009 nowhere.
VIEWS_SEED = 1009
# the first tower conv and the first ANM deform conv: the earliest layers,
# whose gradients hold every BatchNorm's and the losses' global reductions
EARLY = ("feature_extraction.firstconv.0.0.weight", "normal_estimator.deform_conv1.weight")
# tests/test_torch_train.py's ZERO_GRAD: the two deform convs' biases feed
# batch-statistics BatchNorms, so their exact gradient is zero
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _global_batch():
    """tests/test_torch_train.py's whole-step batch (train_batch at 32x32,
    smooth views) with a mask valid on 60% of the first row's pixels and on
    all of the second's."""
    batch = {**train_batch(2, HW, HW), **smooth_views(2, HW, HW, seed=VIEWS_SEED)}
    batch["mask"][0] = (np.random.default_rng(3).uniform(size=(HW, HW)) < 0.6).astype(np.float32)
    return batch


def _capture_grads():
    """An optax stage that passes the gradients on and keeps them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def _jax_step(batch_np):
    """JAX `make_train_step` (f32, Adam) on the global batch from the
    plateau weights, as tests/test_torch_train.py's `jax_step`: the losses,
    and the gradients, batch statistics and weights after, as port
    state_dicts."""
    opt = JaxConfiguration(ranks.NAME, make_workspace=False).get_config()
    model = jax_model_selector(opt)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    template = jax.jit(lambda k, b: model.init(k, b, train=False))(jax.random.PRNGKey(0), batch)
    init = jax.tree_util.tree_map(np.array, flax.serialization.from_bytes(template, ranks.PLATEAU.read_bytes()))
    tx = optax.chain(_capture_grads(), jax_optimizer_selector(opt, 100))
    state = JaxTrainState.create(apply_fn=model.apply, params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                                 batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]), tx=tx)
    new, losses = jax_make_train_step(model, jax_loss_selector(opt), jnp.float32)(state, batch)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": state_dict_from_jax(np_tree(new.opt_state[0]), init["batch_stats"]),
            "state": state_dict_from_jax(np_tree(new.params), np_tree(new.batch_stats))}


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The 2-rank step (spawned from a thread while JAX compiles its step
    here), the one-process port step, the JAX step, all on the global
    batch, and the plateau weights before them."""
    batch = _global_batch()
    assert batch["mask"][0].mean() < 0.65 and batch["mask"][1].mean() == 1.0
    out = {}
    tmp = tmp_path_factory.mktemp("step")
    thread = threading.Thread(target=lambda: out.update(ranks=_spawn(tmp, ranks.train_step_rank, batch)))
    thread.start()
    try:
        jax_ref = _jax_step(batch)
        one = ranks.train_step_rank(batch)
    finally:
        thread.join(timeout=600)
    assert not thread.is_alive() and "ranks" in out
    return out["ranks"], one, jax_ref, ranks.plateau_state_dict()


def _updates(step, before):
    """Each parameter's move in `step` (ZERO_GRAD left out)."""
    return {k: step["state"][k] - before[k] for k in step["grads"] if k not in ZERO_GRAD}


def test_two_rank_step_is_the_one_process_step(steps):
    """Against the one-process port step on the global batch: the global
    losses (1e-5 relative), the gradients of EARLY (1e-5 of their norms;
    3.2e-6 and 3.6e-6 measured) and the updated state, parameters and
    batch statistics (1e-5 of its norm; 2.8e-8 measured), which differ by
    rounding only: the ranks sum BatchNorm's moments, the masked means'
    counts and the gradients in another order, and convolve batches of 1.
    Both ranks hold the same state bit for bit."""
    got, one, _, _ = steps
    floats = [k for k, v in one["state"].items() if v.dtype.kind == "f"]
    for g in got:
        for key, v in one["losses"].items():
            assert g["losses"][key] == pytest.approx(v, rel=1e-5), key
        for name in EARLY:
            assert _rel(g["grads"][name], one["grads"][name]) <= 1e-5, name
        assert _rel(np.concatenate([g["state"][k].ravel() for k in floats]),
                    np.concatenate([one["state"][k].ravel() for k in floats])) <= 1e-5
    assert got[0]["digest"] == got[1]["digest"]
    for name, v in got[0]["state"].items():
        assert np.array_equal(v, got[1]["state"][name]), name


def test_two_rank_step_is_the_jax_step(steps):
    """Against JAX `make_train_step` on the global batch, at
    tests/test_torch_train.py's whole-step tolerances: losses 1e-4
    relative; each gradient and each parameter's update within 1e-3 of its
    norm, the zero-gradient biases' within 1e-6 of their weight's gradient
    norm and 1e-7 absolute; batch statistics 1e-4 relative (1e-6
    absolute)."""
    got, _, ref, before = steps
    g = got[0]
    for key, v in ref["losses"].items():
        assert g["losses"][key] == pytest.approx(v, rel=1e-4), key
    want = _updates(ref, before)
    bad = {}
    for name, grad in g["grads"].items():
        if name in ZERO_GRAD:
            scale = np.linalg.norm(ref["grads"][name.replace(".bias", ".weight")])
            moved = max(np.abs(g["state"][name] - before[name]).max(), np.abs(ref["state"][name] - before[name]).max())
            err = max(max(np.linalg.norm(grad), np.linalg.norm(ref["grads"][name])) / (1e-6 * scale), moved / 1e-7)
        else:
            err = max(_rel(grad, ref["grads"][name]), _rel(g["state"][name] - before[name], want[name])) / 1e-3
        if not err <= 1.0:
            bad[name] = float(err)
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:10]
    for name, v in ref["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g["state"][name], v, rtol=1e-4, atol=1e-6, err_msg=name)


def test_bf16_step_keeps_the_ranks_alike(tmp_path):
    """Under the bf16 policy (`functional_call` over bf16 copies of the
    f32 masters) the gradient all-reduce runs too: both ranks report the
    same global losses and end with the same state bit for bit, every
    parameter moved from the plateau weights."""
    got = _spawn(tmp_path, ranks.train_step_rank, _global_batch(), "bf16")
    before = ranks.plateau_state_dict()
    assert got[0]["losses"] == got[1]["losses"] and np.isfinite(list(got[0]["losses"].values())).all()
    assert got[0]["digest"] == got[1]["digest"]
    for name in got[0]["grads"]:
        assert np.array_equal(got[0]["state"][name], got[1]["state"][name]), name
        assert got[0]["state"][name].dtype == np.float32 and not np.array_equal(got[0]["state"][name], before[name]), name


# ------------------------------------------------------------ the trainer

FIT_DATA = {"height": 48, "width": 48, "train_samples": 2, "test_samples": 3}
TEST_DATA = {"height": 96, "width": 96, "train_samples": 2, "test_samples": 3}


def test_trainer_on_two_ranks(tmp_path):
    """`Trainer.fit` + `test()`, `auto_resume` and a test-mode restore on 2
    ranks (global batch 2; 3 test samples, so rank 1 holds padding only in
    the second eval batch): rank 0 alone wrote the records, the log and the
    checkpoints; both ranks return the same tables and end bit for bit
    alike; the epoch's global losses are the one-process fit's (1e-5
    relative); the test tables from the checkpoint are one process's
    `test()` of the same checkpoint (1e-6 relative: the same weights, the
    rows evaluated in batches of 1 instead of 2)."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "configs", root / "configs")
    got = _spawn(tmp_path, ranks.trainer_rank, root, "ddp", FIT_DATA, TEST_DATA)
    assert got[0]["steps"] == got[1]["steps"] == [1, 2]
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["fit_agg"] == got[1]["fit_agg"] and got[0]["test_agg"] == got[1]["test_agg"]

    ws = root / "workspace" / "stereodpnet_plus" / "ddp"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in records] == ["train", "test", "resume", "train", "test"]
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == ["checkpoint_00.pt", "checkpoint_01.pt"]
    assert load_checkpoint(ws / "checkpoints" / "checkpoint_01.pt")["step"] == 2
    assert len((ws / "output" / "log_text.txt").read_text().splitlines()) == 3  # rank 0's 3 configurations

    one = ranks.configure(root, "one", FIT_DATA)
    Trainer(one, device="cpu", state_dict=ranks.plateau_state_dict()).fit()
    (ref,) = [json.loads(line) for line in (Path(one.output_path) / "metrics.jsonl").read_text().splitlines()]
    for key in ("smoothL1_loss", "cosine_loss", "final_loss"):
        assert records[0][key] == pytest.approx(ref[key], rel=1e-5), key
    ckpt = str(ws / "checkpoints" / "checkpoint_00.pt")
    over = {"mode": "test", "augmentation_config": "config_test"}
    table = Trainer(ranks.configure(root, "one", TEST_DATA, over, load_model=ckpt), device="cpu").test()
    assert set(table) == set(got[0]["test_agg"]) == {"absolute_dp", "affine_dp", "normal_dp"}
    for pack, values in table.items():
        for key, v in values.items():
            assert got[0]["test_agg"][pack][key] == pytest.approx(v, rel=1e-6, abs=1e-12), (pack, key)


def test_cli_under_torchrun_on_the_cpu(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2`
    of the CLI with --device cpu on a tiny run config (SyntheticDP at
    48x48, 32x32 crops, global batch 2, no DataLoader workers): rc 0, one
    train and one test record, the epoch's checkpoint."""
    data = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "SyntheticDP" / "config.json").read_text())
    (tmp_path / "tiny_data.json").write_text(json.dumps({**data, **FIT_DATA}))
    aug = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "preprocess" / "config_train.json").read_text())
    aug["crop_aug"]["soft_crop"]["crop_factor"] = 32
    (tmp_path / "tiny_aug.json").write_text(json.dumps(aug))
    run = json.loads((REPO / "configs" / f"{ranks.NAME}.json").read_text())
    run.update(epoch=1, batch_size=2, workers=0, dataset_config=str(tmp_path / "tiny_data"),
               augmentation_config=str(tmp_path / "tiny_aug"))
    (tmp_path / "tiny.json").write_text(json.dumps(run))
    # the CLI with the workspace root moved to tmp_path
    (tmp_path / "cli.py").write_text(
        "import runpy\n"
        "import dualpixelface_tpu_torch.config.manager as m\n"
        f"m.REPO_ROOT = m.Path({str(tmp_path)!r})\n"
        "runpy.run_module('dualpixelface_tpu_torch.main', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          str(tmp_path / "cli.py"), "--config", str(tmp_path / "tiny.json"), "--workspace", "cli",
                          "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ws = tmp_path / "workspace" / "stereodpnet_plus" / "cli"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in records] == ["train", "test"]
    assert np.isfinite(records[0]["final_loss"]) and records[0]["steps"] == 1.0
    assert sorted(p.name for p in (ws / "checkpoints").iterdir()) == ["checkpoint_00.pt"]


@pytest.mark.parametrize("env, device_type, cards, want", [
    # two nodes of 4 cards, the second node's second rank: its own card, nccl
    ({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, "cuda", 4, (1, "nccl", "cuda:1")),
    # two ranks on a node of one card share it over gloo
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "cuda", 1, (1, "gloo", "cuda:0")),
    # without the node's variables, one node
    ({"WORLD_SIZE": "2", "RANK": "1"}, "cuda", 2, (1, "nccl", "cuda:1")),
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "cpu", 0, (1, "gloo", "cpu")),
], ids=["two-nodes", "shared-card", "one-node", "cpu"])
def test_torchrun_rank_rules(env, device_type, cards, want):
    """The CLI's rank under torchrun: its card is its node's LOCAL_RANK and
    the backend is decided by the node's LOCAL_WORLD_SIZE against the
    node's cards, so several nodes of one card a rank run nccl."""
    from dualpixelface_tpu_torch.main import torchrun_world

    w = torchrun_world(env, device_type, cards)
    assert (w["size"], w["rank"]) == (int(env["WORLD_SIZE"]), int(env["RANK"]))
    local_rank, backend, device = want
    assert (w["local_rank"], w["backend"]) == (local_rank, backend)
    assert parallel.rank_device(w["local_rank"], device_type, cards) == torch.device(device)
