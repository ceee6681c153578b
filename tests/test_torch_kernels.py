"""The PyTorch port's kernel modules (K1 deform conv, K3 fused soft-argmin,
K5 dense 3x3x3 conv) against the JAX package, on the CPU (the backward
kernels K2 and K4 are held to JAX in test_torch_train.py).

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that version's arithmetic against the JAX function (and, at tiny shapes,
against the TPU kernel run in Pallas interpret mode). The CUDA kernels are
held against the same plain versions on the card by `chip_smoke.py`.
Inputs are made with numpy from a seed and fed to both sides; comparisons
are in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualpixelface_tpu.ops.cost_volume import regression_disparities, soft_argmin as jax_soft_argmin
from dualpixelface_tpu.ops.deform_conv3d import _windowed_xla
from dualpixelface_tpu.ops.deform_conv3d import deform_conv3d as jax_deform_conv3d
from dualpixelface_tpu.ops.kernels.conv3d_dslice import _conv3d_call, conv3d_dslice_reference
from dualpixelface_tpu.ops.kernels.deform_fused import deform_conv3d_fused as jax_deform_fused
from dualpixelface_tpu.ops.kernels.fused_softargmin import fused_softargmin as jax_fused_softargmin
from dualpixelface_tpu.ops.resize import upsample3d_trilinear
from dualpixelface_tpu_torch.ops.kernels import launch_counts
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import conv3d_dslice_v2
from dualpixelface_tpu_torch.ops.kernels.deform_fused import deform_conv3d_bwd, deform_conv3d_fused
from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import fused_softargmin, fused_softargmin_bwd
from dualpixelface_tpu_torch.ops.kernels.prims import batched_dot, lane_gather_sum, transpose_sum
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

# f32 on both sides; the sums run in another order (XLA vs ATen), so
# agreement is to a few f32 ulps of the output scale.
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _rng_arrays(seed, *shapes_scales):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in shapes_scales]


def _deform_inputs(seed, b, d, h, w, c, co, scale, integer=False):
    x, off, wt, bias = _rng_arrays(
        seed, ((b, d, h, w, c), 1.0), ((b, d, h, w, 81), scale), ((3, 3, 3, c, co), 0.2), ((co,), 1.0)
    )
    if integer:  # every sampling position lands exactly on a voxel
        off = np.round(off).astype(np.float32)
    return x, off, wt, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "scale,integer",
    [(0.6, False), (4.0, False), (3.0, True)],
    ids=["inside-window", "clamp-binds", "integer-positions"],
)
def test_deform_windowed_matches_jax_windowed_twin(scale, integer):
    x, off, wt, bias = _deform_inputs(1, 2, 4, 7, 9, 5, 6, scale, integer)
    ref = np.asarray(_windowed_xla(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(bias)))
    got = deform_conv3d_fused(*_t(x, off, wt, bias), aperture=True).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    if scale > 1.0:  # the clamp really binds: unbounded sampling differs
        unbounded = deform_conv3d_fused(*_t(x, off, wt, bias), aperture=False).numpy()
        assert np.abs(unbounded - got).max() > 1e-3


@pytest.mark.parametrize("scale,integer", [(0.6, False), (4.0, False), (3.0, True)])
def test_deform_unbounded_matches_jax_packed8(scale, integer):
    x, off, wt, bias = _deform_inputs(2, 1, 3, 6, 8, 4, 5, scale, integer)
    ref = np.asarray(jax_deform_conv3d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(bias),
                                       impl="packed8"))
    got = deform_conv3d_fused(*_t(x, off, wt, bias), aperture=False).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_deform_windowed_matches_pallas_interpret():
    """The TPU kernel itself, run in interpret mode (tiny shape)."""
    x, off, wt, bias = _deform_inputs(3, 1, 4, 8, 8, 5, 7, 2.0)
    ref = np.asarray(jax_deform_fused(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(bias),
                                      interpret=True))
    got = deform_conv3d_fused(*_t(x, off, wt, bias), aperture=True).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("b,d,h,w", [(2, 8, 8, 6), (1, 8, 16, 12)])
def test_fused_softargmin_matches_pallas_interpret(b, d, h, w):
    (cost,) = _rng_arrays(4, ((b, d, h, w), 3.0))
    dv = regression_disparities(-4, 12, d, 4)
    ref = np.asarray(jax_fused_softargmin(jnp.asarray(cost), dv, factor=4))
    got = fused_softargmin(torch.from_numpy(cost), dv, factor=4).numpy()
    # the TPU kernel interpolates with dense dots in another order; the JAX
    # package holds it to 1e-4 against its own oracle (test_pallas_kernels.py)
    err = np.abs(got - ref)
    at = np.unravel_index(np.argmax(err), err.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                               err_msg=f"max abs err {err.max():.3e} at {at}: port {got[at]}, JAX {ref[at]}")


@pytest.mark.parametrize("h", [8, 5, 7], ids=["4h%32==0", "4h%32!=0", "odd"])
def test_fused_softargmin_matches_upsample_then_soft_argmin(h):
    """The JAX oracle (trilinear x4 upsample, then soft-argmin), including
    output heights the TPU kernel rejects (4h % 32 != 0)."""
    (cost,) = _rng_arrays(5, ((2, 8, h, 6), 3.0))
    dv = regression_disparities(-4, 12, 8, 4)
    up = upsample3d_trilinear(jnp.asarray(cost)[..., None], 4)[..., 0]
    ref, _ = jax_soft_argmin(up, dv)
    got = fused_softargmin(torch.from_numpy(cost), dv, factor=4).numpy()
    assert got.shape == (2, 4 * h, 24)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,co", [((2, 4, 9, 7, 35), 81), ((1, 3, 6, 8, 5), 7)])
def test_conv3d_dslice_matches_jax_reference(shape, co):
    x, wt, bias = _rng_arrays(6, (shape, 1.0), ((3, 3, 3, shape[-1], co), 0.1), ((co,), 1.0))
    ref = np.asarray(conv3d_dslice_reference(jnp.asarray(x), jnp.asarray(wt))) + bias
    got = conv3d_dslice(*_t(x, wt, bias)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_conv3d_dslice_matches_pallas_interpret():
    """The TPU kernel itself, run in interpret mode (tiny shape)."""
    x, wt = _rng_arrays(7, ((1, 3, 8, 8, 3), 1.0), ((3, 3, 3, 3, 4), 0.1))
    ref = np.asarray(_conv3d_call(jnp.asarray(x), jnp.asarray(wt), stride=1, interpret=True))
    got = conv3d_dslice(*_t(x, wt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


class _TensorOnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a CUDA tensor on a machine that cannot run the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _wrapper_calls(make):
    # the output widths the kernels are built for: K1 and K2 64, K5 81, T1 32
    x = make(torch.zeros(1, 2, 4, 4, 3))
    off = make(torch.zeros(1, 2, 4, 4, 81))
    w64 = make(torch.zeros(3, 3, 3, 3, 64))
    w81 = make(torch.zeros(3, 3, 3, 3, 81))
    g64 = make(torch.zeros(1, 2, 4, 4, 64))
    cost = make(torch.zeros(1, 8, 4, 4))
    g_up = make(torch.zeros(1, 16, 16))
    dv = regression_disparities(-4, 12, 8, 4)
    # the tools' kernels (T1-T4), at the widths they are built for
    w32 = make(torch.zeros(3, 3, 3, 3, 32))
    tab = make(torch.zeros(2, 4, 128))
    idx = make(torch.zeros(2, 8, 128, dtype=torch.int32))
    slabs = make(torch.zeros(2, 8, 128, 80))
    a, b = make(torch.zeros(2, 32, 16)), make(torch.zeros(2, 16, 64))
    return [
        lambda: deform_conv3d_fused(x, off, w64, None, aperture=True),
        lambda: deform_conv3d_bwd(x, off, w64, None, g64, aperture=True),
        lambda: fused_softargmin(cost, dv, factor=4),
        lambda: fused_softargmin_bwd(cost, g_up, dv, factor=4),
        lambda: conv3d_dslice(x, w81, None),
        lambda: conv3d_dslice_v2(x, w32, None, relu=True),
        lambda: lane_gather_sum(tab, idx),
        lambda: transpose_sum(slabs),
        lambda: batched_dot(a, b),
    ]


@pytest.mark.parametrize(
    "make",
    [lambda t: torch.Tensor._make_subclass(_TensorOnCuda, t), lambda t: t.to("meta")],
    ids=["cuda", "meta"],
)
def test_wrappers_raise_instead_of_falling_back(make):
    """Off the CPU a wrapper launches its kernel or raises: with no CUDA
    toolkit and no card here, every call raises and nothing is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensor could reach a kernel")
    before = launch_counts()
    calls = _wrapper_calls(make)
    assert len(calls) == len(before)  # every kernel's wrapper
    for call in calls:
        with pytest.raises((RuntimeError, ValueError)):
            call()
    assert launch_counts() == before


@pytest.mark.parametrize("kernel", ["deform_conv3d_fused", "deform_conv3d_bwd", "conv3d_dslice", "conv3d_dslice_v2"])
def test_wrappers_refuse_other_output_widths(kernel):
    """K5 and T1 are built for their callers' output widths (81; 32 and
    64): a CUDA call with another width raises before anything is launched
    or counted, while the CPU path takes any width. K1 and K2 take any
    width, as their TPU kernels do (Co 5 here): what they still refuse
    before any launch is a bias that is not [Co]."""
    x = torch.zeros(1, 2, 4, 4, 3)
    off = torch.zeros(1, 2, 4, 4, 81)
    w = torch.zeros(3, 3, 3, 3, 5)
    g = torch.zeros(1, 2, 4, 4, 5)
    deform = kernel.startswith("deform")
    bias = torch.zeros(4 if deform else 5)
    call = {
        "deform_conv3d_fused": lambda x_, o_, w_, g_, b_: deform_conv3d_fused(x_, o_, w_, b_, aperture=True),
        "deform_conv3d_bwd": lambda x_, o_, w_, g_, b_: deform_conv3d_bwd(x_, o_, w_, b_, g_, aperture=True)[2],
        "conv3d_dslice": lambda x_, o_, w_, g_, b_: conv3d_dslice(x_, w_, None),
        "conv3d_dslice_v2": lambda x_, o_, w_, g_, b_: conv3d_dslice_v2(x_, w_, None, relu=True),
    }[kernel]
    assert call(x, off, w, g, None if deform else bias).shape[-1] == 5
    before = launch_counts()
    on_cuda = [torch.Tensor._make_subclass(_TensorOnCuda, t) for t in (x, off, w, g, bias)]
    with pytest.raises(ValueError, match=r"bias \(4,\) must be \[5\]" if deform else "output channels"):
        call(*on_cuda)
    assert launch_counts() == before
