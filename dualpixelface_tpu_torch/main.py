"""Command-line entry of the PyTorch port (counterpart of the repository's
`main.py`; ref main.py:14-64).

    python -m dualpixelface_tpu_torch.main --config train_faceDP --workspace base \\
        [--load_model ckpt.pt] [--profile] [--device cuda|cpu]

`--config` is a run config's name under `configs/` or a path to one. The
run config's `mode` picks what runs: `train` trains (`Trainer.fit`) and
then tests, anything else (`test`, `demo`) tests. `--load_model` restores a
checkpoint of this package (`checkpoint_<epoch>.pt`) before the first
forward; `--profile` wraps the run in a torch.profiler trace written to the
workspace's log directory. The run goes to the card unless `--device cpu`
is given; without a card the default raises.
"""
from __future__ import annotations

import argparse
import random

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="dualpixelface_tpu_torch runner")
    parser.add_argument("--config", type=str, required=True, help="config name under configs/, or a path")
    parser.add_argument("--workspace", type=str, required=True, help="workspace name")
    parser.add_argument("--load_model", type=str, default=None, help="checkpoint to load")
    parser.add_argument("--profile", action="store_true",
                        help="wrap the run in a torch.profiler trace (written to the workspace log dir)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="where the model runs (default: the card)")
    args = parser.parse_args(argv)

    from dualpixelface_tpu_torch import resolve_device
    from dualpixelface_tpu_torch.config import Configuration
    from dualpixelface_tpu_torch.train.trainer import Trainer
    from dualpixelface_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)  # raises before any workspace is made
    configuration = Configuration(args.config, args.workspace, args.load_model)
    configuration.validate()
    opt = configuration.get_config()

    # seed_everything(1) parity (ref main.py:25); the weights' init and the
    # pipeline's draws are seeded explicitly
    random.seed(1)
    np.random.seed(1)

    trainer = Trainer(opt, device=device)
    logdir = opt.get("logger_path") if args.profile else None
    with trace(logdir):
        if opt.mode == "train":
            trainer.fit()
            trainer.test()
        else:
            trainer.test()


if __name__ == "__main__":
    main()
