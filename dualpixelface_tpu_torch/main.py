"""Command-line entry of the PyTorch port (counterpart of the repository's
`main.py`; ref main.py:14-64).

    python -m dualpixelface_tpu_torch.main --config train_faceDP --workspace base \\
        [--load_model ckpt.pt] [--profile] [--device cuda|cpu]
    python -m torch.distributed.run --nproc_per_node 2 -m dualpixelface_tpu_torch.main ... [--device cpu]

`--config` is a run config's name under `configs/` or a path to one. The
run config's `mode` picks what runs: `train` trains (`Trainer.fit`) and
then tests, anything else (`test`, `demo`) tests. `--load_model` restores a
checkpoint of this package (`checkpoint_<epoch>.pt`) before the first
forward. The run goes to the card unless `--device cpu` is given; without
a card the default raises.

`--profile` wraps the run in a torch.profiler trace written to the
workspace's log directory (a Chrome trace TensorBoard reads) and turns the
program's tracer on with annotations (`utils/profiling`): the trace then
holds the program's spans as host ranges beside the kernels they launched
(`serve.*`, `model.*` for each stage of StereoDPNet's forward, `asm.*` for
the ASM's shift, mask head and gate, `train.*` for a step's copy, forward,
losses, backward and update, and `fit.data`, the wait for the next batch,
beside `fit.step`). After the run, `tracer.json` in the same directory holds
the tracer's counters: the host-to-device copies (`h2d.*`), each kernel's
launches (`launch.*`) and the kernel builds and loads (`kernels.*`), and
how often each span was entered.

Data parallelism (`parallel`): under `torchrun` (RANK and WORLD_SIZE set)
each process is one rank of the process group it describes, on its node's
card LOCAL_RANK, over nccl when the node's LOCAL_WORLD_SIZE ranks each have
a card of their own (on one node or several), or on the CPU with `--device
cpu`. Otherwise the CLI starts gcd(batch_size, visible
cards) ranks, one per card, as the JAX Trainer uses every device that
divides the batch (`parallel.world_for`); on one card, or with `--device
cpu`, it runs in this process.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="dualpixelface_tpu_torch runner")
    parser.add_argument("--config", type=str, required=True, help="config name under configs/, or a path")
    parser.add_argument("--workspace", type=str, required=True, help="workspace name")
    parser.add_argument("--load_model", type=str, default=None, help="checkpoint to load")
    parser.add_argument("--profile", action="store_true",
                        help="wrap the run in a torch.profiler trace with the program's spans, and write "
                             "the tracer's counters to tracer.json (both in the workspace log dir)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="where the model runs (default: the card)")
    return parser.parse_args(argv)


def torchrun_world(env, device_type: str, n_cards: int) -> dict:
    """The rank that torchrun's variables in `env` describe: the world's
    size, the global rank, the rank's index on its node (its card) and the
    backend, decided by the node's ranks against the node's `n_cards`
    (`parallel.backend_for`)."""
    from dualpixelface_tpu_torch import parallel

    size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    node_ranks = int(env.get("LOCAL_WORLD_SIZE", size))
    return {"size": size, "rank": rank, "local_rank": local_rank, "node_ranks": node_ranks,
            "backend": parallel.backend_for(device_type, node_ranks, n_cards)}


def run(args: argparse.Namespace) -> None:
    """The run of one rank (or of the one process)."""
    from dualpixelface_tpu_torch import parallel, resolve_device
    from dualpixelface_tpu_torch.config import Configuration
    from dualpixelface_tpu_torch.train.trainer import Trainer
    from dualpixelface_tpu_torch.utils import profiling

    device = resolve_device(args.device)  # raises before any workspace is made
    configuration = Configuration(args.config, args.workspace, args.load_model)
    configuration.validate()
    opt = configuration.get_config()

    # seed_everything(1) parity (ref main.py:25); the weights' init and the
    # pipeline's draws are seeded explicitly
    random.seed(1)
    np.random.seed(1)

    trainer = Trainer(opt, device=device)
    logdir = opt.get("logger_path") if args.profile and parallel.world().main else None
    if logdir is not None:
        profiling.enable(annotate=True)
    with profiling.trace(logdir):
        if opt.mode == "train":
            trainer.fit()
            trainer.test()
        else:
            trainer.test()
    if logdir is not None:
        profiling.write(os.path.join(logdir, "tracer.json"))
        profiling.disable()


def main(argv=None):
    args = parse_args(argv)

    import torch

    from dualpixelface_tpu_torch import parallel, resolve_device
    from dualpixelface_tpu_torch.config import Configuration

    resolve_device(args.device)  # without a card the default raises here
    n_cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun: this process is one rank
        w = torchrun_world(os.environ, args.device, n_cards)
        if w["rank"] == 0:
            print(f"torchrun: {w['size']} ranks, {w['node_ranks']} a node on {args.device} ({n_cards} cards a node), "
                  f"backend {w['backend']}", flush=True)
        parallel.initialize_multiprocess(w["backend"], "env://", w["size"], w["rank"], args.device,
                                         local_rank=w["local_rank"])
        try:
            run(args)
        finally:
            parallel.shutdown()
        return
    size = 1
    if n_cards > 1:
        batch = Configuration(args.config, args.workspace, make_workspace=False).get_config().batch_size
        size = parallel.world_for(batch, n_cards)
    if size > 1:
        parallel.spawn(run, size, args.device, args=(args,))
    else:
        run(args)


if __name__ == "__main__":
    main()
