"""BENCHMARK.json against the contract's shape, and the harness finding a
cell's pieces by name, also for pieces added as new files only."""
from __future__ import annotations

import json
import re
import time

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_parses_and_reports_what_its_metrics_move(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
    loop, ref = cell.loop(), cell.reference()
    assert callable(loop.build) and callable(loop.judge) and callable(ref.build) and cell.limits["limits"]
    for m in cell.per_layer:
        for site in getattr(spec.metric(m["name"]), "SITES", []):
            for work in (site["work"], site.get("backward", site["work"])):
                assert callable(spec.site_work(work))
    assert cell.config["model"]["inplanes"] == 32  # the published widths


def test_metric_units_follow_their_kind():
    for m in BENCH["per_layer"]:
        if m["name"].endswith(("_roofline", "mfu", "idle_share")):
            assert m["unit"] == "%"


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.cell("no.such.cell")


TOY_REFERENCE = '''
"""A toy model: one 3x3 convolution of the two views to a disparity."""
import torch
from torch import nn


class Toy(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.head = nn.Conv2d(6, 1, 3, padding=1)

    def forward(self, batch):
        x = torch.cat([batch["left"], batch["right"]], -1).movedim(-1, 1)
        return {"pred_depth": self.head(x)}


def build(model, precision=None, chunk=None):
    return Toy(model)


def init_state_dict(model, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return {k: torch.randn(v.shape, generator=gen, device=device) for k, v in model.state_dict().items()}


def answer(net, batch, got=None):
    return net({k: batch[k] for k in ("left", "right")})


def gaps(want, got):
    g = got.get("pred_depth")
    if g is None or g.shape != want["pred_depth"].shape:
        return {"disp": None}
    return {"disp": (g.float() - want["pred_depth"]).abs()}
'''

TOY_LOOP = '''
"""Serving a model that stands in for the program: the toy reference."""
import numpy as np
import torch

from benchmark import check

BACKWARD = False


class Toy:
    def __init__(self, cell, state_dict, device):
        self.model = cell.reference().build(cell.config["model"]).to(device)
        self.model.load_state_dict(state_dict)
        self.device = device

    def __call__(self, batch, mark=None):
        with torch.no_grad():
            return self.model({k: torch.as_tensor(batch[k], device=self.device) for k in ("left", "right")})


def build(cell, state_dict, device):
    return Toy(cell, state_dict, device)


def set_up(sut, call, pool, mix, state_dict, sync):
    call(pool[0])
    return {}


def end_to_end(calls, latencies_s, window_s, mix):
    return {"serve_pairs_per_s": (calls * mix["batch"] / window_s, "pairs/s"),
            "serve_p95_ms": (float(np.percentile(np.asarray(latencies_s) * 1e3, 95)), "ms")}


def judge(cell, res, device, detail=None):
    return check.serve_numbers(cell, res["state_dict"], res["kept"], device, detail=detail)


def flops(ref, model, batch):
    ref.build(model)(batch)
'''

TOY_WORK = '''
def work(shape, itemsize, co, image=None):
    b, c, h, w = shape
    return [{"bytes": (b * c * h * w + b * co * h * w) * itemsize, "products": 2.0 * b * h * w * 9 * c * co}]
'''


def test_a_second_reference_model_runs_from_new_files_only(tmp_path, monkeypatch):
    """Another model, with its own plain reference, loop, configuration,
    mix, limits, metric and kernel site, added as new files and entries:
    a run of its cell is correct and a planted fault is not, and the site
    its metric names is hooked (one on a module the model lacks is left
    out)."""
    import torch

    from benchmark import run, trace
    from benchmark.reading import Reading
    from benchmark.work.flops import step_flops

    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    (b / "reference/toy.py").write_text(TOY_REFERENCE)
    (b / "loops/toy_serve.py").write_text(TOY_LOOP)
    (b / "work/toy_conv.py").write_text(TOY_WORK)
    (b / "metrics/toy.head_roofline.py").write_text(
        "SITES = [{'work': 'toy_conv', 'module': 'head'}, {'work': 'toy_conv', 'module': 'no_such_module'}]\n"
        "def read(r):\n    return r.roofline_percent(('toy_conv',))\n")
    (b / "configs/toy.json").write_text(json.dumps({"model_name": "toy", "reference": "toy", "model": {}}))
    mix = json.loads((b / "traffic/serve.f32.b4.json").read_text())
    mix.update(loop="toy_serve", batch=2, height=16, width=12, pool=2, check_batches=1, profile_calls=1)
    (b / "traffic/toy.b2.json").write_text(json.dumps(mix))
    (b / "limits/toy.f32.b2.json").write_text(json.dumps({"limits": {"disp_q99": 1e-5, "disp_far": 0.0},
                                                          "far": {"disp": 1e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy", "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "a second model"})
    bench["workloads"].append({"name": "toy.f32.b2", "config": "toy", "traffic": "toy.b2", "chips": 1, "why": "w"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("toy.f32.b2")
    bench["per_layer"].append({"name": "toy.head_roofline", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "serve_pairs_per_s", "workloads": ["toy.f32.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    argv = ["--workload", "toy.f32.b2", "--seed", str(2 ** 31 + 7), "--seconds", "0.2"]
    line = run.run(argv, root=root, device="cpu", look_for_card=False)[0]
    assert line["correct"] is True and set(line["metrics"]) == {"setup_s", "serve_pairs_per_s", "serve_p95_ms"}

    def off_by_a_little(sut):
        def call(batch, mark=None):
            out = sut(batch)
            return {"pred_depth": out["pred_depth"] + 1e-3}
        return call

    assert run.run(argv, root=root, device="cpu", look_for_card=False, fault=off_by_a_little)[0]["correct"] is False

    cell = spec.cell("toy.f32.b2", root)
    net = cell.reference().build(cell.config["model"])
    sites = trace.Sites(net, spec.metric("toy.head_roofline", root).SITES, cell.loop().BACKWARD, root)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net({"left": torch.zeros(2, 16, 12, 3), "right": torch.zeros(2, 16, 12, 3)})
    sites.close()
    assert sites.shapes == {"site.toy_conv.head": ((2, 6, 16, 12), torch.float32, 1, 1)}
    assert any(e.name == "site.toy_conv.head" for e in prof.events())
    reading = Reading(cell=cell, calls=1, window_s=1.0, spans={}, slice={"sites": {"site.toy_conv.head": [1e-3]}},
                      site_shapes=sites.shapes, flops_per_call=step_flops(cell), window_peak_bytes=0)
    assert 0 < spec.reader("toy.head_roofline", root)(reading) < 100

    class Event:  # a CUDA event's stand-in: the host clock
        def __init__(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(trace, "_event", Event)
    spans = trace.Spans(net, {"head": ("head:start", "head:end"), "gone": ("no_such_module:start", "head:end")})
    spans.begin_call()
    net({"left": torch.zeros(2, 16, 12, 3), "right": torch.zeros(2, 16, 12, 3)})
    spans.mark("forward")
    spans.mark("loss")
    spans.close()
    ms = spans.ms()
    assert set(ms) == {"head", "forward"} and ms["head"][0] >= 0
    assert step_flops(cell) == 2.0 * 2 * 16 * 12 * 9 * 6 * 1
    assert all(p.read_bytes() == b for p, b in before.items())
