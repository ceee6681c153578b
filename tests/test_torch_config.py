"""The PyTorch port's configuration against the JAX package's, on the CPU.

For every run config in `configs/` (the port has every model they name),
the port's merged tree equals the JAX `Configuration(...).data` under the
same temporary root, the workspace paths and the restored checkpoint's
path included, and both make the same workspace; so does dpnet's
`config_multi`; a run config of a model the port lacks raises, naming the
model; the older merge-only `load_config` still gives its tree; the
validation hooks refuse what JAX's refuse; the CLI runs `eval_faceDP_dpnet`
(test mode, a checkpoint restored) and `train_faceDP_bts` on a FaceDP
fixture on the CPU.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu_torch.config import Config, Configuration, load_config
from dualpixelface_tpu_torch.data.SyntheticDP.fixture import write_fixture_tree
from dualpixelface_tpu_torch.train.checkpoint import save_checkpoint
from dualpixelface_tpu_torch.train.state import create_train_state
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent
PORTED = ["train_faceDP", "eval_faceDP", "demo_faceDP", "train_synthetic_stereodpnet",
          "train_synthetic_stereodpnet_plus", "eval_synthetic_stereodpnet", "ci_smoke",
          "train_synthetic_stereonet", "train_faceDP_stereonet", "train_faceDP_psmnet", "train_faceDP_nnet",
          "eval_faceDP_dpnet", "train_faceDP_bts", "train_faceDP_dpnet"]
# run configs written beside the committed ones, of a model (or a model
# config) the port lacks: (the committed config they start from, their
# overrides, the model the error must name)
LACKING = {"train_faceDP_face_seg": ("train_faceDP", {"model_name": "face_seg"}, "face_seg"),
           "eval_faceDP_face_seg": ("eval_faceDP_dpnet", {"model_name": "face_seg"}, "face_seg"),
           "train_faceDP_dpnet_nocfg": ("train_faceDP_dpnet", {"model_config": "config_none"}, "dpnet")}


def _root(tmp_path) -> Path:
    shutil.copytree(REPO / "configs", tmp_path / "configs")
    return tmp_path


def test_every_committed_config_is_listed():
    assert sorted(PORTED) == sorted(p.stem for p in (REPO / "configs").glob("*.json"))


@pytest.mark.parametrize("name", PORTED)
def test_merged_tree_matches_jax(tmp_path, name):
    root = _root(tmp_path)
    ckpt = str(tmp_path / "some" / "checkpoint_03.pt")
    ref = JaxConfiguration(name, workspace="ws", load_model=ckpt, root=root)
    # the directories: JAX's `log_text.txt` handler stays on the first file
    # its process opened, so a later workspace may get no file from it
    made = sorted(p.relative_to(root) for p in (root / "workspace").rglob("*") if p.is_dir())
    shutil.rmtree(root / "workspace")
    got = Configuration(name, workspace="ws", load_model=ckpt, root=root)
    assert got.get_config().to_dict() == ref.data
    assert sorted(p.relative_to(root) for p in (root / "workspace").rglob("*") if p.is_dir()) == made
    model = ref.data["model_name"]
    ws = root / "workspace" / model / "ws"
    assert got.data["ckpt_path"] == str(ws / "checkpoints") and got.data["load_model"] == ckpt
    assert (ws / "output" / "log_text.txt").read_text().count("workspace=ws") == 1
    # by path as by name, and without a workspace
    by_path = Configuration(str(root / "configs" / f"{name}.json"), make_workspace=False, root=root)
    assert by_path.data == JaxConfiguration(name, make_workspace=False, root=root).data


def test_dpnet_config_multi_matches_jax(tmp_path):
    """dpnet's second model config (`model_config: config_multi`), merged
    as JAX merges it."""
    root = _root(tmp_path)
    run = json.loads((root / "configs" / "train_faceDP_dpnet.json").read_text())
    (root / "configs" / "train_faceDP_dpnet_multi.json").write_text(json.dumps({**run, "model_config": "config_multi"}))
    got = Configuration("train_faceDP_dpnet_multi", make_workspace=False, root=root).data
    assert got == JaxConfiguration("train_faceDP_dpnet_multi", make_workspace=False, root=root).data
    assert got["model"]["select_view"] == 3 and got["model"]["loss_weight"][0] == 1.0


@pytest.mark.parametrize("name", sorted(LACKING))
def test_zoo_config_raises_naming_its_model(tmp_path, name):
    root = _root(tmp_path)
    base, over, model = LACKING[name]
    run = json.loads((root / "configs" / f"{base}.json").read_text())
    (root / "configs" / f"{name}.json").write_text(json.dumps({**run, **over}))
    with pytest.raises(NotImplementedError, match=f"model '{model}'"):
        Configuration(name, workspace="ws", root=root)
    assert not (root / "workspace").exists()
    # as an override of a ported config too
    with pytest.raises(NotImplementedError, match=f"model '{model}'"):
        Configuration(base, make_workspace=False, overrides=over)


def test_overrides_resolve_the_layers():
    """Overrides land before the model, dataset and augmentation layers
    resolve, as in JAX."""
    over = {"model_name": "stereodpnet_plus", "dataset_name": "SyntheticDP", "augmentation_config": "config_demo",
            "epoch": 3}
    got = Configuration("train_faceDP", make_workspace=False, overrides=over).data
    assert got == JaxConfiguration("train_faceDP", make_workspace=False, overrides=over).data
    assert got["model"]["fused_regression"] is True and got["dataset"]["height"] == 384
    assert got["photo_aug"]["contrast"] is True and got["epoch"] == 3


def test_load_config_keeps_its_tree():
    model = json.loads((REPO / "dualpixelface_tpu_torch" / "models" / "stereodpnet" / "config.json").read_text())
    cfg = load_config("stereodpnet", model_overrides={"level": 4}, dataset_overrides={"flip_lr": True},
                      run_overrides={"precision": "bf16"})
    assert cfg.to_dict() == {
        "optim": "adam", "init_lr": 1e-4, "scheduler": "steplr", "precision": "bf16", "batch_size": 8,
        "model_name": "stereodpnet", "model": {**model, "level": 4},
        "dataset": {"flip_lr": True, "dp_conversion": "given"},
    }
    assert cfg.model.level == 4 and cfg.dataset.flip_lr is True and cfg.get("epoch", 7) == 7
    assert load_config().model_name == "stereodpnet_plus"
    with pytest.raises(FileNotFoundError):
        load_config("face_seg")


def test_config_access():
    cfg = Config({"a": 1, "b": {"c": [1, {"d": 2}]}, "e": None})
    assert cfg.b.c[1].d == 2 and "b" in cfg and "z" not in cfg and cfg.get("z", 5) == 5
    d = cfg.to_dict()
    d["b"]["c"].append(3)
    assert cfg.to_dict() == {"a": 1, "b": {"c": [1, {"d": 2}]}, "e": None}


@pytest.mark.parametrize("key,value", [("mode", "serve"), ("optim", "lamb"), ("batch_size", 0), ("init_lr", -1.0)])
def test_validate_refuses_as_jax(key, value):
    for cls in (JaxConfiguration, Configuration):
        cfg = cls("train_synthetic_stereodpnet_plus", make_workspace=False, overrides={key: value})
        with pytest.raises(RuntimeError):
            cfg.validate()
    Configuration("train_synthetic_stereodpnet_plus", make_workspace=False).validate()


def test_two_workspaces_in_one_process_each_get_their_log(tmp_path):
    root = _root(tmp_path)
    for ws in ("a", "b"):
        Configuration("train_synthetic_stereodpnet_plus", workspace=ws, root=root)
    for ws in ("a", "b"):
        log = root / "workspace" / "stereodpnet_plus" / ws / "output" / "log_text.txt"
        assert log.read_text().count(f"workspace={ws}") == 1


def run_cli_on_facedp(tmp_path, config: str, crop_factor: int, load_model: str | None = None) -> dict:
    """`python -m dualpixelface_tpu_torch.main --config <config> --device
    cpu` on the committed run config with its dataset cut to a FaceDP
    fixture of 96x96 samples (4 train, 2 test) and its crops' factor to
    `crop_factor`, through files beside a temporary copy, 2 DataLoader
    workers as committed: rc 0; returns the records and the checkpoints."""
    fixture = write_fixture_tree(tmp_path / "rcv", n_train=4, n_test=2, height=96, width=96)
    data = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "FaceDP" / "config.json").read_text())
    (tmp_path / "tiny_data.json").write_text(json.dumps({**data, "path": str(fixture)}))
    run = json.loads((REPO / "configs" / f"{config}.json").read_text())
    aug = json.loads((REPO / "dualpixelface_tpu_torch" / "data" / "preprocess"
                      / f"{run['augmentation_config']}.json").read_text())
    aug["crop_aug"]["soft_crop"]["crop_factor"] = crop_factor
    (tmp_path / "tiny_aug.json").write_text(json.dumps(aug))
    run.update(dataset_config=str(tmp_path / "tiny_data"), augmentation_config=str(tmp_path / "tiny_aug"),
               epoch=1, workers=2)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / f"{config}.json").write_text(json.dumps(run))
    argv = ["main", "--config", config, "--workspace", "cli", "--device", "cpu"]
    if load_model:
        argv += ["--load_model", load_model]
    code = ("import runpy, sys\n"
            "import dualpixelface_tpu_torch.config.manager as m\n"
            f"m.REPO_ROOT = m.Path({str(tmp_path)!r})\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('dualpixelface_tpu_torch.main', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ws = tmp_path / "workspace" / run["model_name"] / "cli"
    records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
    return {"records": records, "checkpoints": sorted(p.name for p in (ws / "checkpoints").iterdir())}


def test_eval_dpnet_through_the_cli_on_the_cpu(tmp_path):
    """`eval_faceDP_dpnet` (test mode, batch 4) restoring a checkpoint the
    port's `train/checkpoint.py` wrote from a seeded dpnet, on the fixture's
    2 test samples at 96x96 crops: one test record, every entry finite but
    rmse_log (`tests/torch_zoo.py` `check_fit` says why), no checkpoint
    written."""
    opt = Configuration("eval_faceDP_dpnet", make_workspace=False).get_config()
    (tmp_path / "ckpt").mkdir()
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), create_train_state(opt, 1, device="cpu", seed=2), 0)
    out = run_cli_on_facedp(tmp_path, "eval_faceDP_dpnet", 96, load_model=ckpt)
    assert [r["mode"] for r in out["records"]] == ["test"] and out["checkpoints"] == []
    test = out["records"][0]
    assert all(np.isfinite(v) for k, v in test.items() if isinstance(v, float) and k != "absolute_dp/rmse_log")


def test_train_bts_through_the_cli_on_the_cpu(tmp_path):
    """`train_faceDP_bts` (ResNet-50, bts_size 256, silog, batch 2) for one
    epoch of the fixture's 4 samples at 64x64 crops (crop factor 32): a
    train record of 2 steps with a finite loss, a test record and the
    epoch's checkpoint."""
    out = run_cli_on_facedp(tmp_path, "train_faceDP_bts", 32)
    assert [r["mode"] for r in out["records"]] == ["train", "test"]
    train = out["records"][0]
    assert train["steps"] == 2.0 and np.isfinite(train["final_loss"]) and "silog_loss" in train
    assert out["checkpoints"] == ["checkpoint_00.pt"]
