"""PyTorch/CUDA port of dualpixelface_tpu for NVIDIA Hopper (H100).

The JAX package `dualpixelface_tpu` is the reference; this package mirrors
its module tree (`config/`, `data/`, `ops/`, `ops/kernels/`, `models/`,
`losses/`, `metrics/`, `train/`, `utils/`) and result contract, with its
own CLI (`python -m dualpixelface_tpu_torch.main`). The TPU Pallas kernels
are hand-written CUDA kernels here (`csrc/`), built with nvcc at first use. Entry points run on the card unless
the caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version.
"""
from __future__ import annotations

import torch

from dualpixelface_tpu_torch import parallel


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: nothing moves to the CPU unless the caller asks for it. In a
    run of several ranks (`parallel`), 'cuda' is this rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type == "cuda" and dev.index is None and parallel.world().size > 1:
        return parallel.rank_device(parallel.world().local_rank, "cuda", parallel.world().cards)
    return dev
