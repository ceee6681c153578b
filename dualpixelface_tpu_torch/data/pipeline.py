"""Batching and shuffling on a torch DataLoader (counterpart of
`dualpixelface_tpu/data/pipeline.py` and `data/grain_pipeline.py`; ref
src/model/*/mainmodel.py train_dataloader, num_workers=opt.workers).

`make_pipeline(option, dataset, training)` gives the batches of the JAX
package's `DataPipeline`, bit for bit and in the same order, whatever the
number of workers; `data_pipeline: grain` maps to the same DataLoader:
  * the epoch's order is `default_rng((seed, epoch)).permutation(n)` when
    shuffling (training), else 0..n-1; batch b takes order[b*B:(b+1)*B];
  * sample i of epoch e draws its augmentation from
    `default_rng((seed, e, i))`. The batch sampler yields (epoch, index)
    pairs, so a worker holds no epoch state;
  * training drops the last partial batch; otherwise the last batch is
    padded with its last sample, and `_valid` marks the real rows;
  * with W ranks (`rank`, `world_size`), rank r takes rows
    [r*B/W, (r+1)*B/W) of each global batch (padded rows and `_valid`
    included): every rank takes the one-process step count, and the rows
    in rank order are the one-process batch. JAX's `DataPipeline` shards
    by stride instead (`shard_index::shard_count`), whose shards differ in
    length when W does not divide n, and whose batches are not the
    one-process ones. B must be a multiple of W;
  * numeric fields are stacked into CPU tensors (`torch.from_numpy`, so
    `pin_memory` can pin them); `groupname` and `pathname` stay lists of
    strings, which `numeric_batch` drops.
`workers` is the DataLoader's `num_workers`; its workers are spawned, not
forked, so none inherits the parent's CUDA context or the OpenMP pool of
`native/libdphost.so`. They persist from epoch to epoch (no worker holds
epoch state, so the batches are the same) and exit when the pipeline is
freed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

_STRING_KEYS = ("groupname", "pathname")


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict of CPU tensors
    (`_valid` a bool tensor), string fields as lists."""
    batch: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in _STRING_KEYS:
            batch[key] = vals
        else:
            batch[key] = torch.from_numpy(np.stack([np.asarray(v) for v in vals], 0))
    return batch


def numeric_batch(batch: dict) -> dict:
    """Drop host-only string fields before device placement."""
    return {k: v for k, v in batch.items() if k not in _STRING_KEYS}


class EpochSamples(Dataset):
    """Sample `index` of `dataset` for the key (epoch, index, valid),
    drawing its augmentation from `default_rng((seed, epoch, index))`, with
    `_valid` set to `valid` (False for a padding row)."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def _load(self, epoch, index):
        rng = np.random.default_rng((self.seed, int(epoch), int(index)))
        return self.dataset.__getitem__(int(index), rng=rng)

    def __getitem__(self, key):
        epoch, index, valid = key
        return {**self._load(epoch, index), "_valid": np.bool_(valid)}

    def __getitems__(self, keys):
        """A batch's samples, each distinct one loaded once (padding rows
        repeat the last sample)."""
        loaded = {}
        for epoch, index, _ in keys:
            if (epoch, index) not in loaded:
                loaded[(epoch, index)] = self._load(epoch, index)
        return [{**loaded[(epoch, index)], "_valid": np.bool_(valid)} for epoch, index, valid in keys]


class EpochBatches(Sampler):
    """Lists of (epoch, index, valid) keys, one per batch, in the epoch's
    order: this rank's rows of each global batch, a short last batch
    padded with its last sample."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"batch_size {batch_size} is no multiple of the {world_size} ranks")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rows = slice(rank * batch_size // world_size, (rank + 1) * batch_size // world_size)
        self.epoch = 0

    def order(self) -> np.ndarray:
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(self.n)
        return np.arange(self.n)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self.order()
        for b in range(len(self)):
            real = [int(i) for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
            keys = [(self.epoch, i, True) for i in real]
            keys += [(self.epoch, real[-1], False)] * (self.batch_size - len(real))
            yield keys[self.rows]


class DataPipeline:
    """An epoch-addressable DataLoader over `dataset`: `set_epoch(e)`, then
    iterate for epoch e's batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 1, num_workers: int = 0,
                 drop_last: bool = False, pin_memory: bool = False, rank: int = 0, world_size: int = 1):
        self.sampler = EpochBatches(len(dataset), batch_size, shuffle, seed, drop_last, rank, world_size)
        self.loader = DataLoader(
            EpochSamples(dataset, seed),
            batch_sampler=self.sampler,
            collate_fn=collate,
            num_workers=num_workers,
            pin_memory=pin_memory,
            multiprocessing_context="spawn" if num_workers > 0 else None,
            persistent_workers=num_workers > 0,
        )

    def set_epoch(self, epoch: int):
        self.sampler.epoch = epoch

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        return iter(self.loader)


def make_pipeline(option, dataset, training: bool, seed: int = 1, pin_memory: bool = False,
                  rank: int = 0, world_size: int = 1) -> DataPipeline:
    """The pipeline of a run config: `batch_size` (the global batch),
    `workers`, shuffled and dropping the last partial batch when
    `training`, this rank's rows of each batch. `pin_memory` is the
    caller's (the run key `pin_memory` where the batches go to the card)."""
    return DataPipeline(
        dataset,
        batch_size=int(option.batch_size),
        shuffle=training,
        seed=seed,
        num_workers=int(option.workers),
        drop_last=training,
        pin_memory=pin_memory,
        rank=rank,
        world_size=world_size,
    )
