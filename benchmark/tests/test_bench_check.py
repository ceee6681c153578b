"""The check that decides `correct`, driven through whole runs of each
cell at the TINY size on the CPU (the look for a card skipped): a sound
run is correct; the control (the reference one precision lower, put in
the program's place) and each fault planted under the timed path are not."""
from __future__ import annotations

import pytest
import torch

from benchmark import check, run, spec
from benchmark.loops.serve import tile_swapped

SERVE = ("stereodpnet_plus.serve.bf16.b4", "stereodpnet.serve.f32.b4")
TRAIN = "stereodpnet.train.f32.b4"
SEED = str(2 ** 31 + 12345)  # past 32 signed bits


def _run(root, cell, fault=None, trace=0):
    return run.run(["--workload", cell, "--seed", SEED, "--seconds", "1", "--trace", str(trace)], root=root,
                   device="cpu", look_for_card=False, fault=fault)[0]


def _lower(cell):
    return {"bf16": "fp8", "f32": "tf32"}[spec.cell(cell).mix["precision"]]


@pytest.mark.parametrize("cell", [*SERVE, TRAIN])
def test_a_sound_run_is_correct(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and all(c["limit"] is not None for c in line["checks"].values())
    assert "setup_s" in line["metrics"] and line["device"]["count"] == 1


def _answers_swapped(sut):
    def call(batch, mark=None):
        out = sut(batch)
        return {k: None if v is None else v.roll(1, 0) for k, v in out.items()}
    return call


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny_root, cell):
    assert _run(tiny_root, cell, fault=_answers_swapped)["correct"] is False


def _a_tile_wrong(sut):
    """Half a percent of the first sample's pixels, a square tile, answered
    wrong: the disparity off by 100, the normals turned round. A fault the
    99th percentile over the batch leaves out."""
    def call(batch, mark=None):
        out = dict(sut(batch))
        wrong = {"pred_depth": out["pred_depth"] + 100.0, "pred_normal": -out["pred_normal"]}
        tiled = tile_swapped({k: torch.cat([v[:1], wrong[k][:1]]) for k, v in out.items() if k in wrong},
                             batch["left"].shape[1:3])
        for k in wrong:
            out[k] = torch.cat([tiled[k][:1], out[k][1:]])
        return out
    return call


@pytest.mark.parametrize("cell", SERVE)
def test_a_wrong_tile_is_not_correct(tiny_root, cell):
    line = _run(tiny_root, cell, fault=_a_tile_wrong)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["disp_q99"]["value"] <= checks["disp_q99"]["limit"]
    assert checks["disp_far"]["value"] > checks["disp_far"]["limit"]


def _state_unchanged(sut):
    sut.state.apply_gradients = lambda: None
    return sut


def _half_batch(sut):
    def call(batch, mark=None):
        return sut({k: v[: len(v) // 2] for k, v in batch.items()}, mark)
    return call


def _step_size_off(sut):
    """Adam's step size 1.4 times the configuration's."""
    schedule = sut.state.schedule
    sut.state.schedule = lambda step: 1.4 * schedule(step)
    return sut


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _step_size_off])
def test_a_train_fault_is_not_correct(tiny_root, fault):
    assert _run(tiny_root, TRAIN, fault=fault)["correct"] is False


def test_a_wrong_step_size_shows_in_the_whole_change(tiny_root):
    checks = _run(tiny_root, TRAIN, fault=_step_size_off)["checks"]
    assert checks["change_total"]["value"] > 0.3 > checks["change_total"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_the_serving_control_is_not_correct(tiny_root, cell):
    """The reference with its products one precision lower, in the
    program's place, against the cell's limits."""
    c = spec.cell(cell, tiny_root)
    res = run.measure(c, int(SEED), 0.5, False, "cpu")
    net = check.reference_model(c, res["state_dict"], "cpu", _lower(cell))
    lowered = []
    with torch.no_grad():
        for batch, _ in res["kept"]:
            x = {k: torch.as_tensor(v).float() for k, v in batch.items()}
            lowered.append((batch, c.reference().answer(net, x)))
    numbers = check.serve_numbers(c, res["state_dict"], lowered, "cpu")
    assert not check.judge(numbers, c.limits["limits"])


def test_the_train_control_is_not_correct(tiny_root):
    c = spec.cell(TRAIN, tiny_root)
    res = run.measure(c, int(SEED), 0.5, False, "cpu")
    batches = res["pool"][:c.mix["check_steps"]]
    want = check.train_reference(c, res["state_dict"], batches, "cpu")
    low = check.train_reference(c, res["state_dict"], batches, "cpu", precision=_lower(TRAIN))
    assert not check.judge(check.train_numbers(low, want), c.limits["limits"])
