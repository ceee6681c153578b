"""The port's tracer (`dualpixelface_tpu_torch/utils/profiling.py`) on the
CPU: off it records nothing and touches neither the CUDA clock nor the
profiler; on, a serving call and a train step give the span tree of the
program's layers, the host-to-device copies are counted where they happen,
a profiler session sees the spans as ranges only when asked and times none
of them, and each of the benchmark's readers of the tracer reads a number
from a traced run and None where its span is absent. Device times come from
a fake event pair standing in for CUDA's (no card here)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import spec
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.models.stereodpnet import normal_module
from dualpixelface_tpu_torch.ops import asm, cost_volume, deform_conv3d, resize
from dualpixelface_tpu_torch.profile_train import train_batch
from dualpixelface_tpu_torch.serve import Predictor, bench_batch
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step
from dualpixelface_tpu_torch.utils import profiling

H, W = 64, 48
C = 8  # inplanes: narrow, so the calls stay quick
MODELS = ("stereodpnet_plus", "stereodpnet")
STAGES = ("model.feature_extraction", "model.cost_volume", "model.aggregation", "model.regression",
          "model.normal_estimator")
# spans a call opens under model.cost_volume: two views, each (plus: two shifts) x one head, one gate
ASM_SPANS = {"stereodpnet_plus": {"asm.shift": 4, "asm.mask_head": 2, "asm.gate": 2},
             "stereodpnet": {"asm.shift": 2, "asm.mask_head": 2, "asm.gate": 2}}
READERS = ("call_host_ms", "h2d_host_ms", "h2d_copies", "asm_host_ms", "asm_shift_ms", "asm_gate_ms")
METRICS = ([f"{p}.{m}" for p in ("serve", "exact_serve") for m in READERS]
           + ["train.h2d_host_ms", "train.h2d_copies"])
CACHED = (asm._phase_operator, resize._device_linear, resize._device_nearest, deform_conv3d._window_bounds,
          normal_module._device_planes, cost_volume.row_valid_mask)


class FakeEvent:
    """A CUDA event's interface on the host clock."""

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and no counts."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture
def fake_device(monkeypatch):
    monkeypatch.setattr(profiling, "_device_stream", lambda: "stream")
    monkeypatch.setattr(profiling, "_device_event", FakeEvent)


def _predictor(model):
    return Predictor(load_config(model, model_overrides={"inplanes": C}), device="cpu", dtype=torch.float32)


def _train_step():
    cfg = load_config("stereodpnet", model_overrides={"inplanes": C})
    state = create_train_state(cfg, 100, device="cpu")
    return state, make_train_step(state.model, loss_selector(cfg))


def _tree(records, call):
    return [(r["name"], r["parent"]) for r in records if r["call"] == call]


def test_off_span_is_the_shared_no_op_and_a_call_records_nothing(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the tracer, off, reached the clock, the profiler or a CUDA event")

    assert profiling.span("serve.call") is profiling.span("model.cost_volume") is profiling._OFF
    pred = _predictor("stereodpnet_plus")
    batch = bench_batch(1, H, W)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_device_event", refuse)
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    pred(batch)
    assert profiling.snapshot()["spans"] == {} and profiling.records() == []


@pytest.mark.parametrize("model", MODELS)
def test_a_serving_call_gives_the_layers_span_tree(model, fake_device):
    pred = _predictor(model)
    batch = bench_batch(1, H, W)
    profiling.enable()
    pred(batch)
    pred(batch)
    recs = profiling.records()
    calls = sorted({r["call"] for r in recs})
    assert calls == [1, 2]
    for call in calls:
        tree = _tree(recs, call)
        want = ([("serve.h2d", "serve.call")] + [(s, "serve.call") for s in STAGES] + [("serve.call", None)]
                + [(n, "model.cost_volume") for n, k in ASM_SPANS[model].items() for _ in range(k)])
        assert sorted(tree, key=str) == sorted(want, key=str)
        assert tree[-1] == ("serve.call", None)  # the outermost closes last
    spans = profiling.snapshot()["spans"]
    for name, s in spans.items():
        assert s["calls"] == 2 * ASM_SPANS[model].get(name, 1) and s["untimed"] == 0
        assert 0 <= s["self_host_ms"] <= s["host_ms"] and s["device_ms"] is not None
    assert spans["model.cost_volume"]["self_host_ms"] < spans["model.cost_volume"]["host_ms"]
    assert spans["serve.call"]["host_ms"] >= sum(spans[s]["host_ms"] for s in STAGES)


def test_a_train_step_gives_the_train_tree_and_marks_in_their_old_order(fake_device):
    state, step = _train_step()
    closed_at = []

    def mark(name):
        closed_at.append((name, sorted(n for n, s in profiling.snapshot()["spans"].items() if s["calls"])))

    profiling.enable()
    step(state, train_batch(1, H, W), mark=mark)
    phases = ["train.h2d", "train.forward", "train.loss", "train.backward", "train.update"]
    assert [m for m, _ in closed_at] == ["forward", "loss", "backward", "update", "end"]
    for i, (_, closed) in enumerate(closed_at):
        assert [p for p in phases if p in closed] == phases[:i + 1]
        assert "train.step" not in closed
    tree = _tree(profiling.records(), 1)
    assert tree[-1] == ("train.step", None)
    assert {(p, "train.step") for p in phases} <= set(tree)
    assert {(s, "train.forward") for s in STAGES} <= set(tree)
    assert ("asm.gate", "model.cost_volume") in tree
    assert profiling.snapshot()["spans"]["train.step"]["calls"] == 1


def test_h2d_counts_the_request_and_soft_argmins_vector_each_call():
    pred = _predictor("stereodpnet")
    batch = bench_batch(2, H, W)
    pred(batch)
    dvals = pred.model.disparities
    per_call = []
    for _ in range(2):
        before = profiling.counters()
        pred(batch)
        after = profiling.counters()
        per_call.append({k: after[k] - before.get(k, 0) for k in after})
    request = sum(v.nbytes for v in batch.values())
    # the request's four arrays and the one head's bin vector, every call, all pageable
    want = {"h2d.copies": len(batch) + 1, "h2d.bytes": request + 4 * len(dvals),
            "h2d.pageable_bytes": request + 4 * len(dvals)}
    assert per_call == [want, want]
    before = profiling.counters()["h2d.copies"]
    cost_volume.soft_argmin(torch.zeros(1, len(dvals), 4, 4), dvals)
    cost_volume.soft_argmin(torch.zeros(1, len(dvals), 4, 4), dvals)
    assert profiling.counters()["h2d.copies"] == before + 2


def test_a_cached_constant_counts_once_across_calls():
    for fn in CACHED:
        fn.cache_clear()
    normal_module._device_planes((0.5, 1.5), "cpu")
    normal_module._device_planes((0.5, 1.5), "cpu")
    assert profiling.counters()["h2d.copies"] == 1
    pred = _predictor("stereodpnet_plus")
    batch = bench_batch(1, H, W)
    copies = []
    for _ in range(3):
        before = profiling.counters()["h2d.copies"]
        pred(batch)
        copies.append(profiling.counters()["h2d.copies"] - before)
    assert copies[0] > copies[1] == copies[2] == len(batch) + 1


@pytest.mark.parametrize("annotate", [False, True])
def test_under_the_profiler_spans_are_ranges_only_when_asked_and_untimed(annotate):
    pred = _predictor("stereodpnet_plus")
    batch = bench_batch(1, H, W)
    profiling.enable(annotate=annotate)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pred(batch)
    names = {e.name for e in prof.events()}
    ours = {"serve.call", "serve.h2d", *STAGES, "asm.shift", "asm.gate"}
    assert (ours <= names) if annotate else not (ours & names)
    spans = profiling.snapshot()["spans"]
    assert spans["serve.call"]["untimed"] == 1 and all(s["calls"] == 0 for s in spans.values())
    assert profiling.records() == []
    pred(batch)  # after the session: timed again
    assert profiling.snapshot()["spans"]["serve.call"]["calls"] == 1


@pytest.fixture(scope="module")
def traced_snapshot():
    """The tracer's snapshot of one serving call and one train step, with
    fake device events."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "_device_stream", lambda: "stream")
        mp.setattr(profiling, "_device_event", FakeEvent)
        pred = _predictor("stereodpnet_plus")
        state, step = _train_step()
        batch = bench_batch(1, H, W)
        pred(batch)
        profiling.enable()
        pred(batch)
        step(state, train_batch(1, H, W))
        snap = profiling.snapshot()
        profiling.disable()
    return snap


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_a_traced_run_and_none_without_its_span(name, traced_snapshot, monkeypatch):
    read = spec.reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: traced_snapshot)
    value = read(None)
    assert isinstance(value, float) and np.isfinite(value) and value > 0
    if name.endswith("h2d_copies"):  # the arrays, and a bin vector a head (three heads in train mode)
        arrays, heads = (len(train_batch(1, H, W)), 3) if name.startswith("train") else (len(bench_batch(1, H, W)), 1)
        assert value >= arrays + heads
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(None) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the tracer
    assert read(None) is None
