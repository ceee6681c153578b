"""The PyTorch port's configuration against the JAX package's, on the CPU.

For every run config in `configs/` whose model the port has, the port's
merged tree equals the JAX `Configuration(...).data` under the same
temporary root, the workspace paths and the restored checkpoint's path
included, and both make the same workspace; a run config of a model the
port lacks raises, naming the model; the older merge-only `load_config`
still gives its tree; the validation hooks refuse what JAX's refuse.
"""
import json
import shutil
from pathlib import Path

import pytest

from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu_torch.config import Config, Configuration, load_config
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent
PORTED = ["train_faceDP", "eval_faceDP", "demo_faceDP", "train_synthetic_stereodpnet",
          "train_synthetic_stereodpnet_plus", "eval_synthetic_stereodpnet", "ci_smoke",
          "train_synthetic_stereonet", "train_faceDP_stereonet", "train_faceDP_psmnet", "train_faceDP_nnet"]
ZOO = {"eval_faceDP_dpnet": "dpnet", "train_faceDP_bts": "bts", "train_faceDP_dpnet": "dpnet"}


def _root(tmp_path) -> Path:
    shutil.copytree(REPO / "configs", tmp_path / "configs")
    return tmp_path


def test_every_committed_config_is_listed():
    assert sorted(PORTED + list(ZOO)) == sorted(p.stem for p in (REPO / "configs").glob("*.json"))


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


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_config_raises_naming_its_model(tmp_path, name):
    root = _root(tmp_path)
    with pytest.raises(NotImplementedError, match=f"model '{ZOO[name]}'"):
        Configuration(name, workspace="ws", root=root)
    assert not (root / "workspace").exists()
    # as an override of a ported config too
    with pytest.raises(NotImplementedError, match=f"model '{ZOO[name]}'"):
        Configuration("train_faceDP", make_workspace=False, overrides={"model_name": ZOO[name]})


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
        load_config("dpnet")


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
