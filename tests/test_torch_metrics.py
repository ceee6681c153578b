"""The port's metric packs against the JAX package's, on the CPU.

Seeded result dicts (the port's: torch tensors; JAX's: the same values as
jax arrays) and batch dicts (numpy) go through both packs, with the mask
on and off; both compute on the host in float64 numpy from float32
inputs, so the values must agree to rounding. Then the bank's
accumulation and its table, and the bf16 results the serving path
returns.
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.config import Configuration
from dualpixelface_tpu.metrics import metric_selector as jax_metric_selector
from dualpixelface_tpu.utils.table import Table as JaxTable
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.metrics import available_metrics, metric_selector
from dualpixelface_tpu_torch.utils import Table, tensor2numpy
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)


def _inputs(seed, mask=True, conf=False, b=2, h=24, w=20):
    """A batch (the tiny batch's ground truth, a random mask) and results
    near it: disparities with noise, normals with noise."""
    rng = np.random.default_rng(seed)
    batch = _tiny_batch(b, h, w)
    if mask:
        batch["mask"] = (rng.random((b, h, w)) < 0.7).astype(np.float32)
    else:
        del batch["mask"]
    if conf:
        batch["conf"] = rng.uniform(0.2, 1.0, (b, h, w)).astype(np.float32)
    results = {
        "pred_depth": (batch["disp"][:, None] + rng.standard_normal((b, 3, h, w)) * 0.3).astype(np.float32),
        "pred_normal": (batch["normal"][:, None] + rng.standard_normal((b, 1, h, w, 3)) * 0.5).astype(np.float32),
    }
    return results, batch


def _both(results, batch, target_type="disp"):
    jopt = Configuration("train_synthetic_stereodpnet", make_workspace=False).get_config()
    jopt.model.target_type = target_type
    want = jax_metric_selector(jopt)({k: jnp.asarray(v) for k, v in results.items()},
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    bank = metric_selector(load_config("stereodpnet", model_overrides={"target_type": target_type}))
    have = bank({k: torch.from_numpy(v) for k, v in results.items()}, batch)
    return want, have, bank


@pytest.mark.parametrize("conf", [False, True], ids=["no-conf", "conf"])
@pytest.mark.parametrize("mask", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("target_type", ["disp", "depth"])
def test_metric_packs_match_jax(target_type, mask, conf):
    """Every key of absolute_dp, affine_dp and normal_dp, within 1e-9
    relative: both packs take the same float32 values to float64 numpy."""
    results, batch = _inputs(30 + 2 * mask + conf, mask, conf)
    if target_type == "depth":
        results["pred_depth"] = np.abs(batch["depth"][:, None] + results["pred_depth"] * 10.0).astype(np.float32)
    want, have, bank = _both(results, batch, target_type)
    assert set(have) == set(want) == {"absolute_dp", "affine_dp", "normal_dp"}
    for bench in bank.benchmarks:
        assert len(have[bench.registry_name]) == len(bench.keys)
        np.testing.assert_allclose(np.asarray(have[bench.registry_name], np.float64),
                                   np.asarray(want[bench.registry_name], np.float64), rtol=1e-9, atol=1e-12,
                                   err_msg=bench.registry_name)


def test_metric_bank_accumulates_like_jax():
    """Two batches logged, then `aggregate` (the per-key means), `viewer`'s
    tables and `clear`, against the JAX bank; a result without normals
    skips the normal pack in both."""
    jopt = Configuration("train_synthetic_stereodpnet", make_workspace=False).get_config()
    jbank = jax_metric_selector(jopt)
    bank = metric_selector(load_config("stereodpnet"))
    assert available_metrics() == ["absolute_dp", "affine_dp", "normal_dp"]
    for seed in (40, 41):
        results, batch = _inputs(seed)
        jbank({k: jnp.asarray(v) for k, v in results.items()}, {k: jnp.asarray(v) for k, v in batch.items()})
        bank({k: torch.from_numpy(v) for k, v in results.items()}, batch)
    want, have = jbank.aggregate(), bank.aggregate()
    assert list(have) == list(want)
    for pack in want:
        assert list(have[pack]) == list(want[pack])
        np.testing.assert_allclose(list(have[pack].values()), list(want[pack].values()), rtol=1e-9)
    jout, out = io.StringIO(), io.StringIO()
    with redirect_stdout(jout):
        jbank.viewer()
    with redirect_stdout(out):
        bank.viewer()
    assert out.getvalue() == jout.getvalue()
    bank.clear()
    assert bank.aggregate() == {}
    results, batch = _inputs(42)
    no_normal = {"pred_depth": torch.from_numpy(results["pred_depth"]), "pred_normal": None}
    assert set(bank(no_normal, batch)) == {"absolute_dp", "affine_dp"}


def test_metric_packs_take_bf16_results():
    """The serving path's bf16 results: the port's packs widen them to
    float32 before any arithmetic, so they agree with the JAX packs on the
    same values held as float32 (1e-9 relative). On bfloat16 arrays the JAX
    packs convert disparity to depth and take its log in bfloat16, which
    moved rmse_log by 23% here; the port does not follow that."""
    results, batch = _inputs(50)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in results.items()}
    assert all(a.dtype == np.float32 for a in tensor2numpy(bf).values())
    want, _, _ = _both({k: v.float().numpy() for k, v in bf.items()}, batch)
    got = metric_selector(load_config("stereodpnet"))(bf, batch)
    assert set(got) == set(want)
    for pack in want:
        np.testing.assert_allclose(np.asarray(got[pack], np.float64), np.asarray(want[pack], np.float64),
                                   rtol=1e-9, err_msg=pack)


def test_table_matches_jax():
    rows = [[0.123456789, 2, "x"], [1e-7, -3.5, "a long cell name"]]
    t, j = Table().set_header(["a", "bb", "ccc"]), JaxTable().set_header(["a", "bb", "ccc"])
    for r in rows:
        t.add_row(r)
        j.add_row(r)
    assert t.draw() == j.draw() == str(t)
