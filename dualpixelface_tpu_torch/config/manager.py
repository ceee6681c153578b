"""4-layer JSON configuration (counterpart of `dualpixelface_tpu/config/manager.py`;
ref config_/config_manager.py:8-95).

A run config (`configs/<name>.json` at the repository root, or a path) is
merged with the selected model's config (this package's
`models/<model_name>/<model_config>.json`), the selected dataset's config
(`data/<dataset_name>/<dataset_config>.json`) and the named augmentation
preset (`data/preprocess/<augmentation_config>.json`), then wrapped in a
recursive attribute-access `Config`. The workspace is
`workspace/<model_name>/<workspace>/{log, output, checkpoints}` under the
root, with `output/log_text.txt`.

The run keys mean here what they mean in the JAX package: `accelerator`
'jit', 'dp' and 'ddp' all train data-parallel over the cards that divide
the batch (the JAX trainer's gcd(batch, devices) rule; the CLI starts one
rank per card, `parallel.world_for`), `sync_batch` is true (BatchNorm's
statistics are the global batch's once several ranks train), and
`precision` is 32 or 'bf16'. With several ranks, rank 0 alone makes the
workspace and writes `log_text.txt`; every rank gets its paths.
A run config whose model the port does not have raises, naming it.

`load_config` is the older merge-only entry point of the profilers, the
bench script and the tests: a packaged model config with default run and
dataset keys, no run config and no workspace.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

from dualpixelface_tpu_torch import parallel
from dualpixelface_tpu_torch.utils.file_manager import error_handler, makedir_custom, setup_logger

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_ROOT.parent

# `load_config`'s dataset keys (the ones the models and losses read:
# select_ref_target, prepare_disparity_gt), the values of the SyntheticDP
# dataset config.
DATASET_DEFAULTS = {"flip_lr": False, "dp_conversion": "given"}

# `load_config`'s run keys (the ones the train step reads), the values of
# configs/train_synthetic_stereodpnet_plus.json.
RUN_DEFAULTS = {"optim": "adam", "init_lr": 1e-4, "scheduler": "steplr", "precision": 32, "batch_size": 8}


class Config:
    """Recursive attribute-access wrapper over a dict (ref config.py:4-10)."""

    def __init__(self, d: dict):
        self._raw = d
        for key, value in d.items():
            if isinstance(value, (list, tuple)):
                setattr(self, key, [Config(x) if isinstance(x, dict) else x for x in value])
            else:
                setattr(self, key, Config(value) if isinstance(value, dict) else value)

    def to_dict(self) -> dict:
        return copy.deepcopy(self._raw)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __contains__(self, key):
        return key in self._raw

    def __repr__(self):
        return f"Config({json.dumps(self._raw, default=str, indent=2)})"


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def available_model_configs() -> list[str]:
    """The models this package carries a config for."""
    return sorted(p.parent.name for p in (PACKAGE_ROOT / "models").glob("*/config.json"))


class Configuration:
    """Merge the 4 JSON layers into one config tree and set up the workspace
    (ref config_/config_manager.py:17-95)."""

    def __init__(
        self,
        config: str,
        workspace: str = "default",
        load_model: str | None = None,
        root: Path | str | None = None,
        make_workspace: bool = True,
        overrides: dict | None = None,
    ):
        self.root = Path(root) if root is not None else REPO_ROOT
        self.data: dict = {"model": {}, "dataset": {}}
        self.workspace = workspace

        config_path = Path(config)
        if not config_path.is_file():
            config_path = self.root / "configs" / (config + ".json")
        error_handler(config_path.is_file(), f"invalid config name: {config}", __name__, True)
        self.config_path = config_path

        self.data["load_model"] = str(Path(load_model).absolute()) if load_model else None
        self._initialize(make_workspace, overrides)

    def _initialize(self, make_workspace: bool, overrides: dict | None = None):
        self.data.update(_load_json(self.config_path))
        # overrides land before the model/dataset/augmentation layers resolve,
        # so overriding model_name etc. picks up the right sub-configs
        if overrides:
            self.data.update(overrides)
        # as the JAX package sets it (ref config_manager.py:57): BatchNorm
        # over the global batch when several ranks train (ops/blocks)
        self.data["sync_batch"] = True

        # the model layer is checked before the workspace is made, so a
        # run config of a model the port lacks leaves nothing behind
        model_name = self.data["model_name"]
        model_cfg = PACKAGE_ROOT / "models" / model_name / (self.data.get("model_config", "config") + ".json")
        if not model_cfg.is_file():
            raise NotImplementedError(
                f"model {model_name!r} (run config {self.config_path.name}) is not in the PyTorch port; "
                f"it has {available_model_configs()}"
            )

        if make_workspace:
            model_path = self.root / "workspace" / model_name
            workspace_path = model_path / self.workspace
            logger_path = workspace_path / "log"
            output_path = workspace_path / "output"
            ckpt_path = workspace_path / "checkpoints"
            if parallel.world().main:
                for path in (logger_path, output_path, ckpt_path):
                    makedir_custom(path)
                logger_text = setup_logger("dualpixelface_tpu_torch.train_log", str(output_path / "log_text.txt"))
                logger_text.info("config=%s workspace=%s", self.config_path, self.workspace)
            self.data.update(
                {
                    "model_path": str(model_path),
                    "workspace_path": str(workspace_path),
                    "logger_path": str(logger_path),
                    "output_path": str(output_path),
                    "ckpt_path": str(ckpt_path),
                }
            )

        # model config layer (ref config_manager.py:70-72)
        self.data["model"] = _load_json(model_cfg)

        # dataset config layer (ref config_manager.py:75-77)
        data_cfg = (
            PACKAGE_ROOT / "data" / self.data["dataset_name"] / (self.data.get("dataset_config", "config") + ".json")
        )
        error_handler(data_cfg.is_file(), f"invalid dataset config: {data_cfg}", __name__, True)
        self.data["dataset"] = _load_json(data_cfg)

        # augmentation preset layer (ref config_manager.py:80-84)
        if "augmentation" in self.data:
            preset = _load_json(PACKAGE_ROOT / "data" / "preprocess" / (self.data["augmentation_config"] + ".json"))
            for aug in self.data["augmentation"]:
                if aug in preset:
                    self.data[aug] = preset[aug]

    def option_check(self, value, options=None):
        """Validation hook (ref config_manager.py:39-41)."""
        error_handler(value in (options or ()), f"option_check failed: {value}", __name__, True)

    def range_check(self, value, min=None, max=None):
        """Validation hook (ref config_manager.py:43-46)."""
        if min is not None:
            error_handler(value >= min, "range_check failed", __name__, True)
        if max is not None:
            error_handler(value <= max, "range_check failed", __name__, True)

    def validate(self):
        """Minimal semantic validation of the merged config."""
        self.option_check(self.data.get("mode"), ("train", "test", "demo"))
        self.option_check(self.data.get("optim"), ("adam", "sgd", "rmsprop"))
        self.range_check(self.data.get("batch_size", 1), min=1)
        self.range_check(self.data.get("init_lr", 1e-4), min=0.0)

    def update(self, config: dict | None):
        if config is not None:
            self.data.update(config)

    def get_config(self) -> Config:
        return Config(self.data)


def load_config(
    model_name: str = "stereodpnet_plus",
    model_overrides: dict | None = None,
    dataset_overrides: dict | None = None,
    run_overrides: dict | None = None,
) -> Config:
    """Merge the packaged model config (`models/<model_name>/config.json`),
    the run keys and the dataset keys into one tree: `cfg.model_name`,
    `cfg.<run key>`, `cfg.model.<key>`, `cfg.dataset.<key>`."""
    path = PACKAGE_ROOT / "models" / model_name / "config.json"
    if not path.is_file():
        raise FileNotFoundError(f"no model config {path}")
    model = _load_json(path)
    model.update(model_overrides or {})
    dataset = dict(DATASET_DEFAULTS)
    dataset.update(dataset_overrides or {})
    run = dict(RUN_DEFAULTS)
    run.update(run_overrides or {})
    return Config({**run, "model_name": model_name, "model": model, "dataset": dataset})
