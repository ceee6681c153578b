"""CUDA graphs of a model's stages, for serving.

    graphs = StageGraphs(model, ("feature_extraction", "cost_volume", "aggregation"))

A serving forward made of many small kernels can be paced by the host's issue
of them, not by the card. `StageGraphs` replays each named stage (a
submodule path) from a `torch.cuda.CUDAGraph`, so the host issues a stage
in one launch. The kernels, their order and their arithmetic stay those
of the eager stage.

Per stage and input signature (each tensor argument's shape, strides,
dtype and device; every other argument's value), the first call runs the
stage eagerly, which fills the lru-cached device constants and cuDNN's
plans; the second captures the stage into a graph, every graph drawing on
one memory pool, and replays it; later calls copy their tensor arguments
into the graph's static inputs and replay. A stage runs eagerly in train
mode and while autograd records: a replay has no backward.

The stage's module call stays, so its hooks fire around the replay; the
capture calls the stage's own forward, so they do not fire inside it.
Counters (`utils/profiling`): `serve.graph_captures`, and
`serve.graph_replays`, one per stage a call.

A stage's result is its graph's static output. The graphs share their
pool, so that output holds until the next replay of any of them: a caller
keeps only what it computes from it, as `STEREODPNET.forward` does. A
stage may not copy from the host per call (a capture cannot hold a
pageable copy), so the model declares which of its stages qualify.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree

from dualpixelface_tpu_torch.utils.profiling import count


@dataclass
class Captured:
    graph: object
    inputs: list     # static inputs, one per tensor argument
    outputs: object  # the stage's output as captured: static tensors


def _signature(args) -> tuple:
    return tuple((a.shape, a.stride(), a.dtype, a.device) if torch.is_tensor(a) else a for a in args)


class StageGraphs:
    """Replays `stages` of `model` from CUDA graphs (see the module's
    docstring). `graph` makes a graph object: `torch.cuda.CUDAGraph`, or in
    tests a stand-in with its `capture_begin(pool=)`, `capture_end()`,
    `replay()` and `pool()`. `close()` gives the stages back their eager
    forward."""

    def __init__(self, model, stages, graph=None):
        self.graph = torch.cuda.CUDAGraph if graph is None else graph
        self.pool = None
        self.stream = None
        self.warm: set = set()
        self.captured: dict[tuple, Captured] = {}
        self.modules = [model.get_submodule(name) for name in stages]
        for name, module in zip(stages, self.modules):
            module.forward = self._stage(name, module, module.forward)

    def close(self) -> None:
        for module in self.modules:
            del module.forward  # the class's forward again
        self.modules = []

    def _stage(self, name, module, forward):
        def run(*args):
            if module.training or torch.is_grad_enabled():
                return forward(*args)
            key = (name, _signature(args))
            entry = self.captured.get(key)
            if entry is None:
                if key not in self.warm:
                    self.warm.add(key)
                    return forward(*args)
                entry = self.captured[key] = self._capture(forward, args)
                count("serve.graph_captures")
            else:
                for static, a in zip(entry.inputs, (a for a in args if torch.is_tensor(a))):
                    static.copy_(a)
            entry.graph.replay()
            count("serve.graph_replays")
            return pytree.tree_map(lambda t: t, entry.outputs)  # fresh containers, the same tensors
        return run

    def _capture(self, forward, args) -> Captured:
        static = [a.clone() if torch.is_tensor(a) else a for a in args]  # clone keeps a dense layout's strides
        device = next(a.device for a in args if torch.is_tensor(a))
        graph = self.graph()
        with self._capture_stream(device):
            graph.capture_begin(pool=self.pool)
            try:
                outputs = forward(*static)
            finally:
                graph.capture_end()
        if self.pool is None:
            self.pool = graph.pool()
        return Captured(graph, [a for a in static if torch.is_tensor(a)], outputs)

    @contextlib.contextmanager
    def _capture_stream(self, device):
        """A CUDA capture runs on a side stream that follows the current
        one (the legacy default stream cannot capture)."""
        if device.type != "cuda":
            yield
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)
