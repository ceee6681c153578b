"""Data parallelism across processes (counterpart of
`dualpixelface_tpu/parallel/mesh.py`; ref main.py:43-58 accelerator 'ddp'
with sync_batchnorm, config_/config_manager.py:57).

JAX runs one program over a device mesh: XLA inserts the gradient
all-reduce after the backward, and BatchNorm and the losses reduce over the
global batch because the program sees all of it. Here each process is one
rank holding its rows of every global batch, and the same three reductions
are explicit collectives of `torch.distributed`:

  * `all_reduce_sum`, an autograd all-reduce (sum forward, sum of the
    gradient backward), takes BatchNorm's moments (`ops/blocks`) over the
    global batch, so the gradient that reaches each rank's input through
    the global mean and variance holds every rank's terms;
  * `global_count` gives the losses' masked means (`losses/common`) their
    global denominator;
  * `all_reduce_grads` sums the gradients after the backward and divides
    by the world size, before the optimizer's update (`train/steps`).

The rules, each a function here and none a fallback taken on a failure:
rank r runs on `cuda:(r % device_count)` (`rank_device`; r is the rank's
index on its node, torchrun's LOCAL_RANK, which is the rank itself for
`spawn`), or on the CPU when asked; the backend is nccl when every rank of a
node has a card of its own and gloo on the CPU or when ranks share a card
(`backend_for`, given the ranks on one node); a run uses
gcd(batch, cards) processes (`world_for`), the JAX Trainer's rule. Every
collective on a CUDA tensor is an all-reduce, a broadcast or a barrier
(gloo's CUDA path covers those); Python objects (the eval's results for the
metrics on rank 0) travel over a gloo group on the CPU (`World.objects`).

    world = initialize_multiprocess("gloo", "tcp://localhost:29500", 2, rank)
    results = spawn(fn, 2, "cpu", args)   # fn(*args) on each rank; its returns
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import pickle
import socket
import warnings

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the run: `size` ranks, this one `rank`
    (`local_rank` on its node), the `backend` of the default group (None
    for one process), `objects`, the gloo group that carries Python objects
    on the CPU, and `cards`, the number of cards the node's ranks spread
    over (0 on the CPU)."""

    size: int = 1
    rank: int = 0
    backend: str | None = None
    objects: object = None
    cards: int = 0
    local_rank: int = 0

    @property
    def main(self) -> bool:
        return self.rank == 0


_world = World()


def world() -> World:
    """The world of this process: `initialize_multiprocess`'s, else one rank."""
    return _world


def world_for(batch_size: int, n_cards: int) -> int:
    """The number of ranks for a global batch on `n_cards` cards: the most
    that divides the batch, gcd(batch, cards), as the JAX Trainer sizes its
    mesh (`dualpixelface_tpu/train/trainer.py:36-57`); warns when that
    leaves cards idle."""
    use = math.gcd(int(batch_size), max(int(n_cards), 1))
    if use < n_cards:
        warnings.warn(f"batch_size={batch_size} does not divide the {n_cards} cards; using only {use}. "
                      f"Set batch_size to a multiple of {n_cards} to use every card.", stacklevel=2)
    return use


def backend_for(device_type: str, node_ranks: int, n_cards: int) -> str:
    """nccl when the ranks run on cards and each of the `node_ranks` ranks
    on a node has its own of the node's `n_cards`; gloo on the CPU or when
    ranks share a card (nccl refuses two ranks on one card)."""
    return "nccl" if device_type == "cuda" and node_ranks <= n_cards else "gloo"


def rank_device(local_rank: int, device_type: str, cards: int) -> torch.device:
    """The device of the rank `local_rank` on its node: `cuda:(local_rank %
    cards)`, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % cards)
    return torch.device(device_type)


def initialize_multiprocess(backend: str, init_method: str, world_size: int, rank: int,
                            device_type: str = "cuda", cards: int | None = None,
                            local_rank: int | None = None) -> World:
    """Join the process group of `world_size` ranks as `rank` (the twin of
    `initialize_multihost`), the node's ranks spread over its first `cards`
    cards (all visible by default) by `local_rank`, the rank's index on its
    node (`rank` itself by default: one node); for a card, make the rank's
    card current first, so the kernels launch there. Nothing happens for
    one process."""
    global _world
    if world_size <= 1:
        return _world
    local_rank = rank if local_rank is None else local_rank
    cards = (cards or torch.cuda.device_count()) if device_type == "cuda" else 0
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(local_rank, "cuda", cards))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    objects = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    _world = World(size=world_size, rank=rank, backend=backend, objects=objects, cards=cards, local_rank=local_rank)
    return _world


def shutdown() -> None:
    """Leave the process group; the process is one rank again."""
    global _world
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = World()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients, since
    every rank's result feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, differentiably (x itself for one rank)."""
    return _AllReduceSum.apply(x) if _world.size > 1 else x


def global_count(count: torch.Tensor) -> torch.Tensor:
    """`count` summed over the ranks, without a gradient."""
    count = count.detach()
    if _world.size > 1:
        count = count.clone()
        dist.all_reduce(count)
    return count


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of `values` (no gradient)."""
    if _world.size <= 1:
        return values.detach()
    return global_count(values) / _world.size


def all_reduce_grads(params, world: World) -> None:
    """The gradients of `params` replaced by their mean over the ranks: one
    coalesced f32 all-reduce, then a divide by the world size."""
    if world.size <= 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat /= world.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier() -> None:
    if _world.size > 1:
        dist.barrier()


def state_digest(module: torch.nn.Module) -> int:
    """A 63-bit hash of the bytes of `module`'s parameters and buffers."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def check_replicated(module: torch.nn.Module, what: str) -> None:
    """Raise unless every rank holds `module`'s parameters and buffers bit
    for bit: the largest and the smallest digest over the ranks agree."""
    if _world.size <= 1:
        return
    device = next(module.parameters()).device
    d = state_digest(module)
    both = torch.tensor([d, -d], dtype=torch.int64, device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if int(both[0]) != -int(both[1]):
        raise RuntimeError(f"rank {_world.rank}: {what} differ between the ranks")


def gather_to_main(obj):
    """The ranks' `obj`s in rank order on rank 0 (None elsewhere), pickled
    over the CPU group."""
    if _world.size <= 1:
        return [obj]
    out = [None] * _world.size if _world.main else None
    dist.gather_object(obj, out, dst=0, group=_world.objects)
    return out


def broadcast_from_main(obj):
    """Rank 0's `obj` on every rank, over the CPU group."""
    if _world.size <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_world.objects)
    return box[0]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, world_size, backend, init_method, device_type, cards, queue):
    initialize_multiprocess(backend, init_method, world_size, rank, device_type, cards)
    try:
        result = fn(*args)
    finally:
        shutdown()
    queue.put((rank, pickle.dumps(result)))


def spawn(fn, world_size: int, device_type: str = "cuda", args=(), init_method: str | None = None,
          cards: int | None = None) -> list:
    """Run `fn(*args)` on `world_size` spawned ranks (process group set up
    by the rules above over the first `cards` cards, all visible by
    default; `init_method` a `tcp://localhost:<free port>` unless given)
    and return each rank's return value, in rank order; `fn` must be
    importable and return picklable values. A rank that raises or dies
    ends the others, and the error is raised here."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.spawn on 'cuda' but CUDA is not available; pass device_type='cpu'")
        cards = min(cards or torch.cuda.device_count(), torch.cuda.device_count())
    else:
        cards = 0
    backend = backend_for(device_type, world_size, cards)
    init_method = init_method or f"tcp://localhost:{free_port()}"
    print(f"parallel.spawn: {world_size} ranks on {device_type} ({cards} cards), backend {backend}", flush=True)
    queue = torch.multiprocessing.get_context("spawn").SimpleQueue()
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, world_size, backend, init_method, device_type, cards, queue),
        nprocs=world_size, join=False, start_method="spawn")
    results = {}

    def drain():
        while not queue.empty():
            rank, payload = queue.get()
            results[rank] = pickle.loads(payload)  # written by this function's own ranks

    while not context.join(timeout=0.5):
        drain()
    drain()
    return [results[r] for r in range(world_size)]
