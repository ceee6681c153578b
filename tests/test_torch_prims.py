"""The port's T2-T4 primitives (`ops/kernels/prims.py`) against the TPU
kernel bodies of `tools/bench_vpu_prims.py`, on the CPU.

The tool is loaded by path as a fresh module, with its grid cut to 3, its
`pallas_call` run in interpret mode and its timer replaced by one that
records the inputs it is handed and the kernel's output. Those inputs go
through the port's wrappers, which take their plain PyTorch versions on
the CPU. The CUDA kernels are held against the same plain versions on the
card by `chip_smoke.py`.
"""
import functools
import importlib
import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dualpixelface_tpu_torch.ops.kernels import launch_counts
from dualpixelface_tpu_torch.ops.kernels.prims import batched_dot, dot_route, lane_gather_sum, transpose_sum
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "bench_vpu_prims.py")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def tool(monkeypatch):
    """A fresh copy of the JAX tool whose runs record (inputs, output)."""
    spec = importlib.util.spec_from_file_location("bench_vpu_prims_under_test", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    runs = []

    def timeit(fn, *args, **_):
        runs.append((args, fn(*args)))
        return 1.0

    monkeypatch.setattr(mod, "GRID", 3)
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec))
    monkeypatch.setattr(mod, "timeit", timeit)
    np.random.seed(0)
    return mod, runs


def _torch(a):
    """A JAX array as a torch tensor of the same values (bf16 through f32,
    exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lane_gather_sum_matches_pallas_gather_bench(tool, dtype):
    mod, runs = tool
    mod.gather_bench(16, DTYPES[dtype][0])
    (tab, idx), ref = runs[0]
    assert tab.shape == (3, 16, 128) and idx.shape == (3, 8, 128)
    assert idx.dtype == (jnp.int32 if dtype == "float32" else jnp.int16)
    got = lane_gather_sum(_torch(tab), _torch(idx))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))  # same adds, same order, same dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transpose_sum_matches_pallas_transpose_bench(tool, dtype):
    mod, runs = tool
    mod.transpose_bench(DTYPES[dtype][0])
    (x,), ref = runs[0]
    assert x.shape == (3, 8, 128, 80)
    got = transpose_sum(_torch(x))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (3, 80, 128)
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_dot_matches_pallas_dot_bench(tool, dtype):
    mod, runs = tool
    mod.dot_bench(8, 32, 16, DTYPES[dtype][0])
    (a, b), ref = runs[0]
    got = batched_dot(_torch(a), _torch(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 8, 16)
    # f32 sums of 32 exact products in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


class _TensorOnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_cuda(t):
    return torch.Tensor._make_subclass(_TensorOnCuda, t)


@pytest.mark.parametrize("case", [
    "gather-int64-index", "gather-int32-index-bf16", "gather-int16-index-f32", "gather-rank", "gather-width",
    "gather-index-rows", "transpose-rank", "transpose-width", "dot-rank", "dot-inner", "dot-cuda-width",
    "dot-cuda-k-f32", "dot-cuda-k-bf16",
])
def test_prims_wrappers_refuse_bad_inputs(case):
    """Each wrapper raises on a wrong index type, rank or width before
    anything is launched or counted; T4's kernel takes n = 64 only, and rows
    of k * element size a multiple of 16 bytes (its TMA and cp.async
    granule: k % 4 in f32, k % 8 in bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    tab = torch.zeros(2, 4, 128)
    idx = torch.zeros(2, 8, 128, dtype=torch.int32)
    call, err = {
        "gather-int64-index": (lambda: lane_gather_sum(tab, idx.long()), TypeError),
        "gather-int32-index-bf16": (lambda: lane_gather_sum(tab.to(bf16), idx), TypeError),
        "gather-int16-index-f32": (lambda: lane_gather_sum(tab, idx.short()), TypeError),
        "gather-rank": (lambda: lane_gather_sum(tab[0], idx), ValueError),
        "gather-width": (lambda: lane_gather_sum(torch.zeros(2, 4, 64), idx), ValueError),
        "gather-index-rows": (lambda: lane_gather_sum(tab, idx[:, :4]), ValueError),
        "transpose-rank": (lambda: transpose_sum(torch.zeros(8, 128, 80)), ValueError),
        "transpose-width": (lambda: transpose_sum(torch.zeros(2, 8, 128, 64)), ValueError),
        "dot-rank": (lambda: batched_dot(torch.zeros(4, 8), torch.zeros(8, 64)), ValueError),
        "dot-inner": (lambda: batched_dot(torch.zeros(2, 4, 8), torch.zeros(2, 9, 64)), ValueError),
        "dot-cuda-width": (lambda: batched_dot(_on_cuda(torch.zeros(2, 4, 8, dtype=f32)),
                                               _on_cuda(torch.zeros(2, 8, 16, dtype=f32))), ValueError),
        "dot-cuda-k-f32": (lambda: batched_dot(_on_cuda(torch.zeros(2, 4, 6, dtype=f32)),
                                               _on_cuda(torch.zeros(2, 6, 64, dtype=f32))), ValueError),
        "dot-cuda-k-bf16": (lambda: batched_dot(_on_cuda(torch.zeros(2, 4, 12, dtype=bf16)),
                                                _on_cuda(torch.zeros(2, 12, 64, dtype=bf16))), ValueError),
    }[case]
    before = launch_counts()
    with pytest.raises(err):
        call()
    assert launch_counts() == before


def test_prims_cpu_paths_take_other_widths():
    """On the CPU the plain versions take what the CUDA kernels refuse."""
    a, b = torch.randn(2, 4, 8), torch.randn(2, 8, 16)
    torch.testing.assert_close(batched_dot(a, b), torch.bmm(a, b), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_gather_sum_takes_indices_modulo_128(dtype):
    """The kernel takes each index modulo 128; so does the plain version,
    and an index out of [0, 128) gathers the lane it wraps to."""
    gen = torch.Generator().manual_seed(0)
    tab = torch.randn((2, 4, 128), generator=gen).to(dtype)
    idx = torch.randint(0, 128, (2, 8, 128), generator=gen)
    wrapped = idx + 128 * torch.randint(-2, 3, idx.shape, generator=gen)
    index_dtype = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    torch.testing.assert_close(lane_gather_sum(tab, wrapped.to(index_dtype)),
                               lane_gather_sum(tab, idx.to(index_dtype)), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "tensor_cores"), (torch.float32, "tensor_cores_3xtf32"),
                                        (torch.float16, None)])
def test_dot_route_follows_the_dtype(dtype, name):
    if name is None:
        with pytest.raises(TypeError):
            dot_route(dtype)
    else:
        assert dot_route(dtype) == name


def test_bench_vpu_prims_counts_the_bytes_each_run_moves(monkeypatch):
    """Each run's bytes are its inputs read once and its output written
    once, counted from the shapes without a launch."""
    from dualpixelface_tpu_torch.tools import bench_vpu_prims as vpu

    monkeypatch.setattr(vpu, "GRID", 2)
    gen = torch.Generator().manual_seed(0)
    for run in vpu.RUNS:
        inputs = run.inputs(gen)
        out = run.plain(*inputs)
        assert run.work(inputs)["bytes"] == sum(t.numel() * t.element_size() for t in (*inputs, out)), run.label


def test_bound_ms_takes_the_slowest_of_bytes_and_each_operation_kind():
    from dualpixelface_tpu_torch.tools import PEAK_BYTES, bound_ms

    assert bound_ms(PEAK_BYTES * 1e-3) == (1.0, "bytes")
    assert bound_ms(PEAK_BYTES * 1e-3, (2e9, 1e12), (3e9, 1e12)) == (3.0, "operations")
    assert bound_ms(PEAK_BYTES * 4e-3, (2e9, 1e12)) == (4.0, "bytes")


def test_bench_dslice_fold_checks_both_epilogues():
    """The tool's T1 check (shared with `chip_smoke.py`) covers the conv
    alone and with the folded BatchNorm and ReLU; on the CPU the wrapper is
    the plain version, so both agree exactly."""
    from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold

    inp = fold.site_inputs((1, 2, 4, 3, 8), 32, torch.Generator().manual_seed(0), torch.float32)
    res = fold.check(inp)
    assert [(r["ab"], r["relu"]) for r in res] == [(False, False), (True, True)]
    assert all(r["max_abs_err"] == 0.0 and r["worst_ratio"] == 0.0 for r in res)


@pytest.mark.parametrize("tool", ["bench_vpu_prims", "bench_dslice_fold", "bench_k2_split", "bench_k1_split",
                                  "bench_k4_split", "bench_softargmin", "bench_t1_split", "bench_tools_f32"])
def test_tools_refuse_to_run_without_cuda(tool, monkeypatch):
    """The tools measure the card: without CUDA they exit, and nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = importlib.import_module(f"dualpixelface_tpu_torch.tools.{tool}")
    monkeypatch.setattr(sys, "argv", [tool])
    with pytest.raises(SystemExit, match="CUDA"):
        mod.main()
