"""Data parallelism across processes (counterpart of `dualpixelface_tpu/parallel/`):
the world of ranks, its rules (device, backend, gcd of batch and cards),
the collectives of the train step, BatchNorm and the losses, and `spawn`."""
from dualpixelface_tpu_torch.parallel.mesh import (
    World,
    all_reduce_grads,
    all_reduce_sum,
    backend_for,
    barrier,
    broadcast_from_main,
    check_replicated,
    gather_to_main,
    global_count,
    global_mean,
    initialize_multiprocess,
    rank_device,
    shutdown,
    spawn,
    state_digest,
    world,
    world_for,
)

__all__ = [
    "World", "all_reduce_grads", "all_reduce_sum", "backend_for", "barrier", "broadcast_from_main",
    "check_replicated", "gather_to_main", "global_count", "global_mean", "initialize_multiprocess",
    "rank_device", "shutdown", "spawn", "state_digest", "world", "world_for",
]
