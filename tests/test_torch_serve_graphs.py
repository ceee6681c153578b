"""The serving forward's CUDA graphs (`dualpixelface_tpu_torch/utils/graphs.py`)
on the CPU, with `TapeGraph` standing in for `torch.cuda.CUDAGraph`: it
records every operator the capture runs, with its tensors, and a replay
runs them again on the same tensors, writing each result where the
captured one lives, as a graph's kernels do. The card check
(`chip_smoke.serve_graphs_check`) carries the `card` marker and skips
without a card; on the card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_graphs.py -m card
"""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from benchmark import spec
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.serve import Predictor, bench_batch, seeded_state_dict
from dualpixelface_tpu_torch.utils import profiling
from dualpixelface_tpu_torch.utils.graphs import StageGraphs

H, W = 64, 48
C = 8  # inplanes: narrow, so the calls stay quick
MODELS = ("stereodpnet_plus", "stereodpnet")
STAGES = ("feature_extraction", "cost_volume", "aggregation")


def _storage(t):
    return t.untyped_storage().data_ptr()


class _Tape(TorchDispatchMode):
    """Records each operator call: (op, args, kwargs, outputs, aliased),
    `aliased` where an output shares storage with an input (a view or an
    in-place op: a replay reruns it and keeps its result where it is)."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = {_storage(t) for t in tree_flatten((args, kwargs))[0] if torch.is_tensor(t)}
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        self.ops.append((func, args, kwargs, outs, any(_storage(t) in ins for t in outs)))
        return out


class TapeGraph:
    """`torch.cuda.CUDAGraph`'s interface on the CPU (see the module's
    docstring). `made` lists every graph made."""

    made: list = []

    def __init__(self):
        self.ops, self.mode, self.pool_arg, self.replays = [], None, "unset", 0
        TapeGraph.made.append(self)

    def capture_begin(self, pool=None):
        self.pool_arg = pool
        self.mode = _Tape(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def pool(self):
        return ("pool", id(TapeGraph.made[0]))

    def replay(self):
        self.replays += 1
        for func, args, kwargs, outs, aliased in self.ops:
            got = func(*args, **kwargs)
            if not aliased:
                for dst, src in zip(outs, [t for t in tree_flatten(got)[0] if torch.is_tensor(t)]):
                    dst.copy_(src)


@pytest.fixture(autouse=True)
def fresh():
    TapeGraph.made = []
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


class Scale(torch.nn.Module):
    """A stage: y = relu(x * w + b), with a view and an in-place op."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, x, b):
        y = x.reshape(-1) * self.w
        y.add_(b)
        return [torch.relu(y).reshape(x.shape)]


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stage = Scale()

    def forward(self, x):
        return self.stage(x, 1.0)[0] + 0.5  # the answer: computed eagerly from the stage's output


def _expected(x):
    return torch.relu(x * 2.0 + 1.0) + 0.5


def test_one_capture_per_signature_replays_after_it_and_answers_hold():
    model = Toy().eval()
    graphs = StageGraphs(model, ["stage"], graph=TapeGraph)
    xs = [torch.randn(3, 4) for _ in range(4)]
    kept = []
    with torch.inference_mode():
        for i, x in enumerate(xs):
            kept.append((x, model(x)))
            assert len(TapeGraph.made) == (0 if i == 0 else 1)
        (g,) = TapeGraph.made
        assert g.replays == 3 and g.pool_arg is None
        (entry,) = graphs.captured.values()
        assert torch.equal(entry.inputs[0], xs[-1])  # the last call's input, copied into the static buffer
        for x, got in kept:
            assert torch.equal(got, _expected(x))  # every answer kept, none overwritten by a later replay
            assert _storage(got) not in {_storage(t) for t in [*entry.inputs, *entry.outputs]}
        # a new shape: eager first, then its own capture, on the first graph's pool
        y = torch.randn(5, 2)
        assert torch.equal(model(y), _expected(y)) and len(TapeGraph.made) == 1
        assert torch.equal(model(y), _expected(y)) and len(TapeGraph.made) == 2
        assert TapeGraph.made[1].pool_arg == TapeGraph.made[0].pool()
        # the first shape still replays its own graph
        assert torch.equal(model(xs[0]), _expected(xs[0])) and g.replays == 4
    assert profiling.counters()["serve.graph_captures"] == 2
    assert profiling.counters()["serve.graph_replays"] == 5


def test_autograd_and_train_mode_run_eagerly_and_close_restores_the_stage():
    model = Toy().eval()
    graphs = StageGraphs(model, ["stage"], graph=TapeGraph)
    x = torch.randn(3, 4)
    for _ in range(3):
        model(x).sum().backward()  # autograd records: eager
    model.train()
    with torch.inference_mode():
        for _ in range(3):
            model(x)
    assert TapeGraph.made == [] and model.stage.w.grad is not None
    graphs.close()
    assert "forward" not in vars(model.stage)


def _config(model):
    return load_config(model, model_overrides={"inplanes": C})


@pytest.mark.parametrize("model", MODELS)
def test_stereodpnet_front_stages_replay_bitwise_equal_to_the_eager_forward(model):
    """The real model's three front stages graphed (by the stand-in):
    every call's answer equals the eager model's bit for bit, answers kept
    stay as they were, and none shares storage with a graph's buffer."""
    config = _config(model)
    sd = seeded_state_dict(config)
    graphed = Predictor(config, sd, device="cpu", dtype=torch.float32)
    eager = Predictor(config, sd, device="cpu", dtype=torch.float32)
    assert graphed.graphs is None and graphed.model.graph_stages == STAGES
    graphed.graphs = StageGraphs(graphed.model, graphed.model.graph_stages, graph=TapeGraph)
    batches = [bench_batch(1, H, W, seed=s) for s in (0, 1, 0, 2)]
    kept = []
    for batch in batches:
        got = graphed(batch)
        kept.append((got, {k: None if v is None else v.clone() for k, v in got.items()}))
        want = eager(batch)
        for k, v in want.items():
            assert (v is None and got[k] is None) or torch.equal(got[k], v), k
    assert len(TapeGraph.made) == 3
    assert profiling.counters()["serve.graph_replays"] == 3 * (len(batches) - 1)
    static = {_storage(t) for e in graphed.graphs.captured.values()
              for t in [*e.inputs, *tree_flatten(e.outputs)[0]]}
    for got, copy in kept:
        for k, v in got.items():
            assert (v is None and copy[k] is None) or torch.equal(v, copy[k]), k
            assert v is None or _storage(v) not in static, k


@pytest.mark.parametrize("model", MODELS)
def test_a_cpu_predictor_is_the_eager_forward(model):
    config = _config(model)
    pred = Predictor(config, seeded_state_dict(config), device="cpu", dtype=torch.float32)
    batch = bench_batch(1, H, W, seed=3)
    assert pred.graphs is None
    got = pred(batch)
    with torch.inference_mode():
        want = pred.model({k: torch.as_tensor(v) for k, v in batch.items()})
    for k, v in want.items():
        assert (v is None and got[k] is None) or torch.equal(got[k], v), k


def test_a_model_without_graph_stages_and_compat_nearest_asm():
    """A model that declares no stages has no graphs; under `compat_nearest`
    the ASM copies per call and is left out of the declared stages."""
    assert not hasattr(Predictor(load_config("stereonet"), device="cpu", dtype=torch.float32).model, "graph_stages")
    config = load_config("stereodpnet", model_overrides={"inplanes": C, "compat_nearest": True})
    assert Predictor(config, device="cpu", dtype=torch.float32).model.graph_stages == ("feature_extraction",
                                                                                       "aggregation")


@pytest.mark.parametrize("model", MODELS)
def test_front_stages_copy_nothing_from_the_host_after_one_call(model):
    """Capture's precondition: once a call has filled the cached device
    constants, none of the three front stages counts a host-to-device copy."""
    pred = Predictor(_config(model), device="cpu", dtype=torch.float32)
    batch = bench_batch(1, H, W)
    pred(batch)
    deltas = {}
    for name in STAGES:
        mod = pred.model.get_submodule(name)
        mod.register_forward_pre_hook(lambda m, a, n=name: deltas.__setitem__(n, -profiling.counters().get("h2d.copies", 0)))
        mod.register_forward_hook(lambda m, a, o, n=name: deltas.__setitem__(n, deltas[n] + profiling.counters().get("h2d.copies", 0)))
    pred(batch)
    assert deltas == dict.fromkeys(STAGES, 0)


class _Event:
    def record(self, stream=None):
        raise AssertionError("a span recorded a CUDA event while the stream captured")


def test_a_span_opened_while_capturing_records_no_event(monkeypatch):
    monkeypatch.setattr(profiling, "_device_stream", lambda: "stream")
    monkeypatch.setattr(profiling, "_device_event", _Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    profiling.enable()
    with profiling.span("serve.call"):
        with profiling.span("asm.shift"):
            pass
    spans = profiling.snapshot()["spans"]
    assert spans["asm.shift"]["calls"] == 1 and spans["asm.shift"]["device_ms"] is None


@pytest.mark.parametrize("name", ["serve.graph_replay_share", "exact_serve.graph_replay_share"])
def test_the_replay_share_readers(name, monkeypatch):
    """100 where every call of the window and the slice replayed the three
    stages; None for an eager predictor or a program without the tracer."""
    read = spec.reader(name)
    batch = bench_batch(1, H, W)
    pred = Predictor(_config("stereodpnet_plus"), device="cpu", dtype=torch.float32)
    pred.graphs = StageGraphs(pred.model, pred.model.graph_stages, graph=TapeGraph)
    pred(batch)
    pred(batch)  # set-up: eager, then the capture
    profiling.enable()  # as the harness does, after set-up
    for _ in range(3):
        pred(batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pred(batch)  # the slice's call: untimed, replayed
    assert read(None) == 100.0
    profiling.enable()
    Predictor(_config("stereodpnet_plus"), device="cpu", dtype=torch.float32)(batch)
    assert read(None) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the tracer
    assert read(None) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("model, k3", [("stereodpnet_plus", 1), ("stereodpnet", 0)])
def test_on_the_card_graphed_serving_matches_eager(model, k3, card):
    import chip_smoke

    config = load_config(model)
    chip_smoke.serve_graphs_check(torch, config, seeded_state_dict(config), chip_smoke.card_line(),
                                  {"K1": 2, "K3": k3, "K5": 2})
