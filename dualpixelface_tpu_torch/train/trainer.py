"""Trainer: config -> data -> model -> train / eval steps -> checkpoints and
metrics (counterpart of `dualpixelface_tpu/train/trainer.py`, which replaces
PyTorch-Lightning's Trainer, ref main.py:43-62).

    trainer = Trainer(Configuration("train_faceDP", "base").get_config())  # CUDA
    trainer.fit()    # epochs of train steps, a checkpoint each epoch
    trainer.test()   # eval forwards, the metric bank, its tables

One process on one card, or the CPU when `device="cpu"` is asked for;
without a card the CUDA default raises. In a process group of W ranks
(`parallel.initialize_multiprocess`; the CLI starts one rank per card, the
run key `accelerator` 'jit', 'dp' or 'ddp' alike, as in JAX) each rank
trains on its rows of every global batch, on its own card, and takes the
one-process update (`train/steps`); rank 0 alone writes the records and
the checkpoints, and `test()` measures each global batch on rank 0, so the
tables are the one-process ones. The batches come from `data/pipeline.make_pipeline`
(a torch DataLoader, pinned memory per the run key `pin_memory` on the
card; one per mode, whose workers live as long as the trainer) and go to
the device without a host sync; the train steps' losses
stay on the device and are fetched once per epoch. Each epoch saves
`checkpoint_<epoch>.pt` (all kept); `auto_resume` continues after the
newest one; `validate_every` (default 1) runs `test()` between epochs.
`fit` opens the tracer spans (`utils/profiling`) `fit.data`, the wait for
the pipeline's next batch, and `fit.step`, the step on it.
Records go to stdout, to `output/metrics.jsonl` and, where `tensorboardX`
imports, to TensorBoard in the log directory.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from dualpixelface_tpu_torch import parallel, resolve_device
from dualpixelface_tpu_torch.data.loader_selector import loader_selector
from dualpixelface_tpu_torch.data.pipeline import make_pipeline, numeric_batch
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.metrics import metric_selector
from dualpixelface_tpu_torch.models.base import apply_group_swap
from dualpixelface_tpu_torch.ops.precision import exact_f32, resolve_policy
from dualpixelface_tpu_torch.train.checkpoint import checkpoint_epoch, restore_checkpoint, save_checkpoint
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_eval_step, make_train_step
from dualpixelface_tpu_torch.utils import tensor2numpy
from dualpixelface_tpu_torch.utils.profiling import span, to_device


class Trainer:
    def __init__(self, option, device="cuda", state_dict=None):
        """`option` is a run config (`config.Configuration(...).get_config()`);
        an f32 run (`precision` 32) turns TF32 off for the process
        (`ops.precision.exact_f32`); `state_dict` (reference-named, e.g. `weights.state_dict_from_jax`)
        replaces the seeded init of the weights; a checkpoint named by the
        run key `load_model` is restored over either."""
        self.opt = option
        self.world = parallel.world()
        self.device = resolve_device(device)
        self.state_dict = state_dict
        self.loss_bank = loss_selector(option)
        self.metric_bank = metric_selector(option)
        self.compute_dtype = resolve_policy(option)
        if self.compute_dtype == torch.float32:
            exact_f32()  # f32 convolutions in f32, not TF32 (process-wide)
        self.state = None
        self.train_step = self.eval_step = None
        self._pipes: dict = {}
        self._log_file = None
        self._tb = None
        if getattr(option, "output_path", None):
            self._log_file = Path(option.output_path) / "metrics.jsonl"
        # TensorBoard channel (ref main.py:31-33 TensorBoardLogger) where
        # tensorboardX is available; JSONL + stdout remain the primary sinks
        if getattr(option, "logger_path", None) and self.world.main:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(option.logger_path)
            except ImportError:
                self._tb = None
        self._tb_step = 0

    # ---------- setup ----------

    def _pipeline(self, training: bool):
        """The train or the test pipeline, built on its first call."""
        if training not in self._pipes:
            dataset = loader_selector(self.opt, training)
            pin = bool(self.opt.get("pin_memory", False)) and self.device.type == "cuda"
            # seed=1: seed_everything(1) parity (ref main.py:25)
            self._pipes[training] = make_pipeline(self.opt, dataset, training, seed=1, pin_memory=pin,
                                                  rank=self.world.rank, world_size=self.world.size)
        return self._pipes[training]

    def _to_device(self, batch: dict) -> dict:
        return {k: to_device(v, self.device, non_blocking=True) for k, v in batch.items() if torch.is_tensor(v)}

    def init_state(self, steps_per_epoch: int):
        """A fresh train state (the seeded init or `state_dict`), its steps,
        and the checkpoint of the run key `load_model` restored over it
        (strict per `load_strict`), before any forward."""
        self.state = create_train_state(self.opt, steps_per_epoch, state_dict=self.state_dict,
                                        device=self.device, seed=1)
        self.train_step = make_train_step(self.state.model, self.loss_bank, self.compute_dtype)
        self.eval_step = make_eval_step(self.state.model, self.compute_dtype)
        if self.opt.get("load_model"):
            strict = bool(getattr(self.opt, "load_strict", True))
            restore_checkpoint(self.opt.load_model, self.state, strict)
            parallel.check_replicated(self.state.model, "the restored weights")
        return self.state

    def _log(self, record: dict):
        """One record to stdout, metrics.jsonl and TensorBoard, by rank 0."""
        if not self.world.main:
            return
        record = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                  for k, v in record.items()}
        print(json.dumps(record), flush=True)
        if self._log_file is not None:
            with open(self._log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            tag = record.get("mode", "train")
            for k, v in record.items():
                if isinstance(v, float):
                    self._tb.add_scalar(f"{tag}/{k}", v, self._tb_step)
            self._tb.flush()
            self._tb_step += 1

    # ---------- loops ----------

    def latest_checkpoint(self):
        """(path, epoch) of the newest epoch checkpoint in the workspace, by
        the epoch number in its name, or (None, -1)."""
        ckpt_dir = getattr(self.opt, "ckpt_path", None)
        if not ckpt_dir:
            return None, -1
        ckpts = list(Path(ckpt_dir).glob("checkpoint_*.pt"))
        if not ckpts:
            return None, -1
        last = max(ckpts, key=checkpoint_epoch)
        return str(last), checkpoint_epoch(last)

    def fit(self, epochs: int | None = None):
        epochs = epochs if epochs is not None else self.opt.epoch
        pipe = self._pipeline(training=True)
        validate_every = int(self.opt.get("validate_every", 1))
        start_epoch = 0
        resume_path = None
        if self.opt.get("auto_resume"):
            resume_path, last_epoch = self.latest_checkpoint()
            if resume_path is not None:
                start_epoch = last_epoch + 1
                self._log({"mode": "resume", "checkpoint": resume_path, "epoch": start_epoch})
        self.init_state(len(pipe))
        if resume_path is not None:
            restore_checkpoint(resume_path, self.state, strict=True)
            parallel.check_replicated(self.state.model, "the resumed weights")
        for epoch in range(start_epoch, epochs):
            pipe.set_epoch(epoch)
            t0 = time.time()
            step_losses: list[dict] = []
            # no per-step host sync: the losses stay on the device and are
            # fetched once per epoch
            batches = iter(pipe)
            while True:
                with span("fit.data"):  # the wait for the pipeline's next batch
                    batch = next(batches, None)
                if batch is None:
                    break
                with span("fit.step"):
                    batch = numeric_batch(batch)
                    batch.pop("_valid", None)
                    self.state, losses = self.train_step(self.state, self._to_device(batch))
                step_losses.append(losses)
            n = len(step_losses)
            running: dict = {}
            if step_losses:
                fetched = {k: torch.stack([s[k] for s in step_losses]).cpu().tolist() for k in step_losses[0]}
                for k, values in fetched.items():
                    for v in values:  # summed in step order, as the JAX trainer does
                        running[k] = running.get(k, 0.0) + v
            record = {k: v / max(n, 1) for k, v in running.items()}
            record.update(epoch=epoch, steps=n, sec=round(time.time() - t0, 2),
                          lr=float(self.state.schedule(self.state.step)), mode="train")
            self._log(record)
            if getattr(self.opt, "ckpt_path", None):
                save_checkpoint(self.opt.ckpt_path, self.state, epoch)
            # per-epoch validation with metric tables (ref
            # stereodpnet/mainmodel.py:143-152), on the test pipeline
            if validate_every and (epoch + 1) % validate_every == 0 and epoch + 1 < epochs:
                self.test()
        return self.state

    def test(self):
        pipe = self._pipeline(training=False)
        self.metric_bank.clear()
        if self.state is None:
            # test-only run: the checkpoint of --load_model is restored
            # before the first forward (ref model_selector.py:17-26)
            self.init_state(steps_per_epoch=1)
        save_figs = self.opt.get("mode") == "demo" and getattr(self.opt, "output_path", None)
        for step_idx, batch in enumerate(pipe):
            batch = self._group_swap(batch)
            valid = batch.pop("_valid")
            results = self.eval_step(self.state, self._to_device(numeric_batch(batch)))
            if self.world.size > 1:
                results, batch, valid = self._gather(results, batch, valid)
                if not self.world.main:
                    continue
            nvalid = int(valid.sum())
            results = {k: v[:nvalid] if torch.is_tensor(v) else v for k, v in results.items()}
            # the metric packs take the host batch: the CPU tensors' numpy
            host_batch = {k: v[:nvalid].numpy() for k, v in batch.items() if torch.is_tensor(v)}
            if "depth" in host_batch:
                self.metric_bank(results, host_batch)
            if save_figs:
                from dualpixelface_tpu_torch.utils.visualizer import save_result_fig_depth

                host_results = tensor2numpy({k: v for k, v in results.items() if v is not None})
                save_result_fig_depth(self.opt, host_results, host_batch, 0, step_idx, mode="DEMO")
        if self.world.main:
            self.metric_bank.viewer()
        agg = parallel.broadcast_from_main(self.metric_bank.aggregate())
        self._log({"mode": "test", **{f"{m}/{k}": v for m, d in agg.items() for k, v in d.items()}})
        return agg

    def _group_swap(self, batch: dict) -> dict:
        """`apply_group_swap`, which decides by a batch's first row: with
        several ranks, by the global batch's first row (rank 0's)."""
        if self.world.size == 1 or "groupname" not in batch:
            return apply_group_swap(batch, training=False)
        lead = parallel.broadcast_from_main(batch["groupname"][:1])
        return {**apply_group_swap({**batch, "groupname": lead}, training=False), "groupname": batch["groupname"]}

    @staticmethod
    def _gather(results: dict, batch: dict, valid):
        """Each rank's eval results (as CPU tensors), host batch and `_valid`
        gathered to rank 0 and joined in rank order: the global batch, as
        one process evaluates it. (None, None, None) on the other ranks."""
        local = ({k: v.cpu() if torch.is_tensor(v) else v for k, v in results.items()}, batch, valid)
        parts = parallel.gather_to_main(local)
        if parts is None:
            return None, None, None

        def join(values):
            if torch.is_tensor(values[0]):
                return torch.cat(values)
            if isinstance(values[0], list):  # the string fields
                return [x for v in values for x in v]
            return values[0]

        return ({k: join([p[0][k] for p in parts]) for k in parts[0][0]},
                {k: join([p[1][k] for p in parts]) for k in parts[0][1]},
                torch.cat([p[2] for p in parts]))
