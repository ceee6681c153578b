"""The port's `nnet` against the benchmark's plain reference
(`benchmark/reference/nnet.py`) on the CPU, on one seeded state_dict at
inplanes 8, level 8, a 64x64 crop, batch 2 (the SPP pools need a
quarter-resolution side of 2 inplanes): the same names both ways, both
heads' disparities and probabilities, the normals and the reference
features within float32's tolerances, and the reference with its products
rounded to fp8 (the cell's control) outside them. Then the six `model.*`
spans of `NNET.forward`, the cell `nnet.serve.bf16.b4` as the harness
finds it, and its readers of the program's spans."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import check, generate, spec
from benchmark.reference import nnet as ref
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.serve import Predictor
from dualpixelface_tpu_torch.utils import profiling

CELL = "nnet.serve.bf16.b4"
MODEL = dict(spec.cell(CELL).config["model"], inplanes=8)
SIZE, BATCH, SEED = 64, 2, 11
SPANS = ("model.feature_extraction", "model.cost_volume", "model.aggregation", "model.refinement",
         "model.regression", "model.normal_estimator")
READERS = {"nnet_serve.tower_ms": "model.feature_extraction", "nnet_serve.volume_ms": "model.cost_volume",
           "nnet_serve.aggregation_ms": "model.aggregation", "nnet_serve.refinement_ms": "model.refinement",
           "nnet_serve.regression_ms": "model.regression", "nnet_serve.normal_ms": "model.normal_estimator"}
# f32 tolerances, each with what the port read against the reference on
# seeds 11-13 (the same float32 math through other library calls and
# summation orders); the fp8 reference read at least 0.39, 1.0, 0.47,
# 0.2 and 0.07 on these (table order):
# the disparity gap over the posterior's spread (`ref.gaps`): q99 1.8e-5,
# the largest 4e-5
DISP_Q99, DISP_MAX = 1e-4, 1e-3
NORMAL_MAX = 1e-3  # the normals' gap over the field's deviation: 2e-4, where a normal is short before its normalisation
PROB_MAX = 1e-3  # the posteriors' total variation distance: 2.1e-5
FEATURE_REL = 1e-5  # the largest channel, relative to its largest value: 3e-7


def _state():
    with torch.device("meta"):
        shapes = ref.build(MODEL)
    return ref.init_state_dict(shapes, SEED, "cpu")


def _batch() -> dict:
    mix = dict(spec.cell(CELL).mix, batch=BATCH, height=SIZE, width=SIZE, pool=1)
    return generate.pool(mix, 5, "cpu")[0]


def _port(state_dict):
    model = build_model(load_config("nnet", model_overrides=MODEL), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _reference(state_dict, precision=None):
    net = ref.build(MODEL, precision)
    net.load_state_dict(state_dict, strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def outputs():
    """The reference's answer, the port's and the fp8 reference's, on one
    state_dict and one batch."""
    sd = _state()
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    with torch.no_grad():
        want = ref.answer(_reference(sd), batch)
        return want, _port(sd)(batch), ref.answer(_reference(sd, "fp8"), batch)


def _readings(want, got) -> dict:
    gaps = ref.gaps(want, got)
    feature = (got["ref_feature"] - want["ref_feature"]).abs().max() / want["ref_feature"].abs().max()
    return {"disp_q99": check.quantile(gaps["disp"], 0.99), "disp_max": float(gaps["disp"].max()),
            "normal_max": float(gaps["normal"].max()), "prob_max": float(gaps["prob"].max()),
            "feature_rel": float(feature)}


TOLERANCES = {"disp_q99": DISP_Q99, "disp_max": DISP_MAX, "normal_max": NORMAL_MAX, "prob_max": PROB_MAX,
              "feature_rel": FEATURE_REL}


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off (importing a reader of
    the program's spans turns it on)."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def test_one_state_dict_loads_strictly_into_both():
    sd = _state()
    port = _port(sd)
    net = _reference(port.state_dict())
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}
    assert all(torch.equal(net.state_dict()[k], v) for k, v in sd.items())


def test_outputs_have_the_programs_shapes(outputs):
    want, got, _ = outputs
    h = SIZE // 4
    shapes = {"pred_depth": (BATCH, 2, SIZE, SIZE), "prob_depth": (BATCH, 2, 32, SIZE, SIZE),
              "pred_normal": (BATCH, 1, SIZE, SIZE, 3), "ref_feature": (BATCH, h, h)}
    for key, shape in shapes.items():
        assert tuple(got[key].shape) == tuple(want[key].shape) == shape, key
    assert tuple(want["disp_spread"].shape) == (BATCH, 2, SIZE, SIZE)


@pytest.mark.parametrize("reading", sorted(TOLERANCES))
def test_port_agrees_with_the_reference_in_f32(outputs, reading):
    want, got, _ = outputs
    assert _readings(want, got)[reading] <= TOLERANCES[reading]


@pytest.mark.parametrize("head", [0, 1], ids=["classifier", "refined"])
def test_each_heads_disparity_agrees(outputs, head):
    want, got, _ = outputs
    gap = ref.gaps(want, got)["disp"][:, head]
    assert check.quantile(gap, 0.99) <= DISP_Q99 and float(gap.max()) <= DISP_MAX


@pytest.mark.parametrize("reading", sorted(TOLERANCES))
def test_fp8_reference_lands_outside_the_tolerances(outputs, reading):
    want, _, lowered = outputs
    assert _readings(want, lowered)[reading] > TOLERANCES[reading]


def test_normals_are_unit_length(outputs):
    _, got, _ = outputs
    np.testing.assert_allclose(torch.linalg.vector_norm(got["pred_normal"], dim=-1).numpy(), 1.0, atol=1e-5)


def _predictor():
    return Predictor(load_config("nnet", model_overrides=MODEL), _state(), device="cpu", dtype=torch.float32)


def test_each_stage_span_fires_once_a_call():
    pred = _predictor()
    batch = _batch()
    profiling.enable()
    pred(batch)
    pred(batch)
    spans = profiling.snapshot()["spans"]
    assert spans["serve.call"]["calls"] == 2
    for name in SPANS:
        assert spans[name]["calls"] == 2, name
    recs = [r for r in profiling.records() if r["call"] == 1]
    assert sorted(r["name"] for r in recs if r["parent"] == "serve.call") == sorted(("serve.h2d",) + SPANS)


def test_cell_resolves_with_every_reader():
    cell = spec.cell(CELL)
    assert cell.config["model_name"] == "nnet" and cell.config["reduced"] == []
    assert cell.mix["batch"] == 4 and cell.mix["precision"] == "bf16"
    assert (cell.mix["height"], cell.mix["width"]) == (768, 576)
    assert cell.reference() is spec.module(spec.REPO / "benchmark" / "reference" / "nnet.py")
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    assert not names & {"serve.tower_ms", "serve.anm_ms", "serve.kernel_roofline", "serve.graph_replay_share"}
    for name in names:
        assert callable(spec.reader(name))
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "serve_pairs_per_s", "serve_p95_ms"}


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


@pytest.fixture(scope="module")
def traced_snapshot():
    """The tracer's snapshot of two serving calls, with fake device events."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "_device_stream", lambda: "stream")
        mp.setattr(profiling, "_device_event", FakeEvent)
        pred = _predictor()
        batch = _batch()
        pred(batch)
        profiling.enable()
        pred(batch)
        pred(batch)
        snap = profiling.snapshot()
        profiling.disable()
    return snap


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_span_a_call_and_none_without_it(name, traced_snapshot, monkeypatch):
    read = spec.reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: traced_snapshot)
    value = read(None)
    assert value == pytest.approx(traced_snapshot["spans"][READERS[name]]["device_ms"] / 2) and value > 0
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(None) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the tracer
    assert read(None) is None


def test_nnet_config_is_the_published_one():
    published = json.loads((spec.REPO / "dualpixelface_tpu_torch/models/nnet/config.json").read_text())
    cell = spec.cell(CELL)
    assert cell.config["model"] == published
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "nnet")
    assert entry["source"] == cell.config["source"] and entry["reduced"] == []


def test_init_scales_each_residual_blocks_last_norm():
    """The tower's 3 + C/2 + 3 + 3 basic blocks and dres1-dres4 end in a norm
    at RESIDUAL_SCALE; every other norm's scale is 1."""
    sd = _state()
    scales = {k: v for k, v in sd.items() if k.endswith(".1.weight") and v.dim() == 1}
    scaled = {k for k, v in scales.items() if torch.all(v == ref.RESIDUAL_SCALE)}
    c = MODEL["inplanes"]
    assert len(scaled) == (3 + c // 2 + 3 + 3) + 4
    assert all(k.endswith("convbn2.1.weight") or k.startswith("dres") for k in scaled)
    assert all(torch.all(v == 1.0) for k, v in scales.items() if k not in scaled)


def test_a_call_copies_the_request_alone():
    """After the first call every host-to-device copy of a call is the
    request's: the regression's bins stay on the device."""
    pred = _predictor()
    batch = _batch()
    pred(batch)
    before = profiling.counters()
    pred(batch)
    after = profiling.counters()
    assert after["h2d.copies"] - before["h2d.copies"] == len(batch)
    assert after["h2d.bytes"] - before["h2d.bytes"] == sum(v.nbytes for v in batch.values())


def test_soft_argmin_takes_its_bins_on_the_device_or_from_the_host():
    from dualpixelface_tpu_torch.ops import cost_volume

    cost = torch.randn(2, 8, 5, 4)
    bins = np.arange(8, dtype=np.float32) * 0.5 - 1.0
    before = profiling.counters().get("h2d.copies", 0)
    on_device = cost_volume.soft_argmin(cost, torch.as_tensor(bins))
    assert profiling.counters().get("h2d.copies", 0) == before
    from_host = cost_volume.soft_argmin(cost, bins)
    assert profiling.counters()["h2d.copies"] == before + 1
    for a, b in zip(on_device, from_host):
        assert torch.equal(a, b)
