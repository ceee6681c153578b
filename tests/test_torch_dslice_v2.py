"""The port's T1 (`ops/kernels/conv3d_dslice_v2.py`, the 3x3x3 conv with
the affine + ReLU epilogue) against the TPU kernel and its gradient, on
the CPU.

The forward is held against `_conv3d_call_v2` of the attic module
(`tools/attic/conv3d_dslice_v2.py`, loaded by path) run in Pallas
interpret mode, with and without `ab` and the ReLU, including ragged D/H
blocks and channel counts off the tiles; the gradient against `jax.vjp`
of `conv3d_dslice_v2`, which on the CPU differentiates the XLA twin, as on
the TPU. On the CPU the wrapper runs its plain version; the CUDA kernel is
held against it on the card by `chip_smoke.py`. The f32 route's 3xTF32
arithmetic on its packed operands is emulated against the plain version.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import pack_conv3d_3xtf32
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import COS, conv3d_dslice_v2, conv3d_dslice_v2_plain, route
from dualpixelface_tpu_torch.ops.kernels.split_f32 import product_3xtf32, split_planes
from dualpixelface_tpu_torch.tools.bench_dslice_fold import excess_error
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

ATTIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools", "attic", "conv3d_dslice_v2.py")
SHAPES = [((2, 5, 16, 16, 8), 8), ((1, 8, 24, 16, 32), 32), ((2, 3, 8, 16, 5), 7)]
EPILOGUES = {"none": (False, False), "ab": (True, False), "relu": (False, True), "ab-relu": (True, True)}


@pytest.fixture(scope="module")
def attic():
    spec = importlib.util.spec_from_file_location("attic_conv3d_dslice_v2_under_test", ATTIC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, shape, co):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    wm = (rng.standard_normal((3, 3, 3, c, co)) * 0.1).astype(np.float32)
    ab = np.stack([rng.uniform(0.5, 1.5, co), rng.standard_normal(co) * 0.5]).astype(np.float32)
    return x, wm, ab


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("shape,co", SHAPES, ids=["ragged-d", "tile-c", "odd-c"])
def test_plain_matches_pallas_interpret(attic, shape, co, epilogue, dtype):
    has_ab, relu = EPILOGUES[epilogue]
    x, wm, ab = _inputs(4, shape, co)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = attic._conv3d_call_v2(jnp.asarray(x, jdt), jnp.asarray(wm, jdt), jnp.asarray(ab) if has_ab else None,
                                relu=relu, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = conv3d_dslice_v2(torch.from_numpy(x).to(tdt), torch.from_numpy(wm).to(tdt),
                           torch.from_numpy(ab) if has_ab else None, relu=relu)
    assert got.dtype == tdt and tuple(got.shape) == shape[:-1] + (co,)
    got = got.float().numpy()
    if relu:
        assert (got >= 0).all() and (got == 0).mean() > 0.2
    if dtype == "float32":
        # f32 sums of 27 C products in another order
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        # both round the same f32 epilogue once, from f32 sums in another
        # order: one bf16 ulp of the output, plus the f32 test's 2e-5 for
        # the sums' order (it decides only outputs near 0, where an ulp is
        # smaller than the sum's own rounding: 13 of 98,304 differ at all)
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 2e-5
        bad = np.abs(got - ref) > tol
        assert not bad.any(), f"{bad.sum()} of {bad.size} outputs more than one bf16 ulp apart"


def _grads_port(x, wm, ab, relu, g):
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wm).requires_grad_()
    abt = None if ab is None else torch.from_numpy(ab).requires_grad_()
    conv3d_dslice_v2(xt, wt, abt, relu=relu).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (xt, wt, abt) if t is not None]


def _grads_jax(attic, x, wm, ab, relu, g):
    if ab is None:
        _, vjp = jax.vjp(lambda x_, w_: attic.conv3d_dslice_v2(x_, w_, None, relu), jnp.asarray(x), jnp.asarray(wm))
    else:
        _, vjp = jax.vjp(lambda x_, w_, ab_: attic.conv3d_dslice_v2(x_, w_, ab_, relu),
                         jnp.asarray(x), jnp.asarray(wm), jnp.asarray(ab))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_gradient_matches_jax_vjp(attic, epilogue):
    has_ab, relu = EPILOGUES[epilogue]
    x, wm, ab = _inputs(5, (1, 4, 8, 8, 5), 6)
    g = np.random.default_rng(6).standard_normal((1, 4, 8, 8, 6)).astype(np.float32)
    ab = ab if has_ab else None
    got, ref = _grads_port(x, wm, ab, relu, g), _grads_jax(attic, x, wm, ab, relu, g)
    assert len(got) == len(ref) == (3 if has_ab else 2)
    for name, a, r in zip(("gx", "gw", "gab"), got, ref):
        # f32 sums of up to 256 voxel products in another order
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-5 * scale, err_msg=name)


def test_gradient_at_relu_tie_is_half(attic):
    """Channels with a = b = 0 put the pre-activation at exactly 0 for
    every voxel: JAX's maximum passes half the cotangent there, so b's
    gradient is half the cotangent's sum."""
    x, wm, ab = _inputs(7, (1, 3, 6, 8, 4), 6)
    ab[:, ::2] = 0.0
    g = np.random.default_rng(8).standard_normal((1, 3, 6, 8, 6)).astype(np.float32)
    got, ref = _grads_port(x, wm, ab, True, g), _grads_jax(attic, x, wm, ab, True, g)
    half = 0.5 * g.sum(axis=(0, 1, 2, 3))[::2]
    np.testing.assert_allclose(ref[2][1, ::2], half, rtol=1e-5, atol=1e-5)
    for name, a, r in zip(("gx", "gw", "gab"), got, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-5 * scale, err_msg=name)


def _im2col(x):
    """x [B, D, H, W, C] -> the 3x3x3 pad-1 windows [voxels, 27 C], column
    tap * C + c (the kernel's K order)."""
    b, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [xp[:, kd:kd + d, kh:kh + h, kw:kw + w] for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=-1).reshape(-1, 27 * c)


@pytest.mark.parametrize("co", COS)
def test_f32_route_arithmetic_matches_the_plain_version(co):
    """The f32 route as the kernel computes it, emulated: x padded to 36
    channels and the weight packed into its two TF32 planes [2, Co, Kp] by
    `pack_conv3d_3xtf32` at n_pad = Co, the windows times the planes in
    3xTF32 (`product_3xtf32`, whose split of hi + lo gives the planes back),
    then the affine and the ReLU in f32: within T1's f32 allowance of the
    plain version (`bench_dslice_fold.excess_error`, as on the card)."""
    shape = (2, 3, 6, 5, 35)
    x, wm, ab = (torch.from_numpy(a) for a in _inputs(9, shape, co))
    xp, planes = pack_conv3d_3xtf32(x, wm, co)
    kp = planes.shape[-1]
    assert xp.shape[-1] == 36 and planes.shape == (2, co, kp) and kp % 32 == 0 and kp >= 27 * 36
    wt = planes[0] + planes[1]
    assert torch.equal(split_planes(wt), planes)
    cols = F.pad(_im2col(xp), (0, kp - 27 * 36))
    acc = product_3xtf32(cols, wt.t()).reshape(shape[:-1] + (co,))
    got = torch.clamp_min(acc * ab[0] + ab[1], 0.0)
    ref = conv3d_dslice_v2_plain(x, wm, ab, relu=True)
    assert (ref == 0).float().mean() > 0.2
    assert excess_error(got, ref, torch.float32)["worst_ratio"] <= 1.0


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "tensor_cores"), (torch.float32, "tensor_cores_3xtf32"),
                                        (torch.float16, None)])
def test_route_follows_the_dtype(dtype, name):
    if name is None:
        with pytest.raises(TypeError):
            route(dtype)
    else:
        assert route(dtype) == name


def test_split_tool_patches_the_f32_tile():
    """`tools.bench_t1_split` compiles parts of T1's f32 route out by
    patching the tile it inlines: every text it patches is in `conv_tc.cuh`
    exactly once, the tile replaces the include, and each variant's macro
    lands in the patched source."""
    from dualpixelface_tpu_torch.tools import bench_t1_split as split

    source = split.patched()
    assert '#include "conv_tc.cuh"' not in source and "conv_mainloop_3xtf32" in source
    for flags in split.VARIANTS.values():
        for flag in flags:
            assert flag.removeprefix("-D") in source, flag
    assert "h < 2 * !NO_CONTRACTION_FLAG; ++h) mma_3xtf32<N>(" in source
