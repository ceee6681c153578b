"""The host side of K2's routes (`ops/kernels/deform_fused.py`), on the CPU.

Both routes read x with its channels padded to CP (40 or 64) and each
tap's weight rows packed as [27, CP, Co] (`pack_deform_bwd`); the f32
route (3xTF32) takes those rows split into two TF32 planes
(`pack_deform_bwd_3xtf32`). Through the plain backward, the packed
operands must give the same gradients as the original ones, and every
padded entry must be exactly zero, in the operands and in the gradients.
Which kernel a call takes follows its dtype alone (`bwd_route`,
`bwd_plan`); off the CPU a call launches that kernel or raises, whatever
the dtype and aperture. Past the tuned widths the wide form's operands
(x in whole 64-channel chunks, the rows' and the cotangent's columns in
whole 64-wide N tiles) must give the same gradients too."""
import numpy as np
import pytest
import torch

from dualpixelface_tpu_torch.ops.kernels import launch_counts
from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
    CP_WIDTHS, KTAPS, bwd_plan, bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain, layout, pack_deform_bwd,
    pack_deform_bwd_3xtf32)
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

CINS = [3, 35, 40, 64]  # padded to 40, 40, 40 (as it is), 64 (as it is)


def _operands(cin, seed=0, shape=(1, 3, 5, 4), co=64):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape + (cin,)), rng.standard_normal(shape + (81,)) * 1.5,
              rng.standard_normal((3, 3, 3, cin, co)) * 0.2, rng.standard_normal((co,)),
              rng.standard_normal(shape + (co,))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _unpack(wpk):
    cp = wpk.shape[1]
    return wpk.reshape(3, 3, 3, cp, wpk.shape[2])


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin", CINS)
def test_packed_operands_give_the_same_backward(cin, aperture):
    x, off, w, bias, g = _operands(cin)
    xp, wpk = pack_deform_bwd(x, w)
    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture)
    got = deform_conv3d_bwd_plain(xp, off, _unpack(wpk), bias, g, aperture)
    # f32 sums over 27 x Cin (forward) and 64 (gcols) terms, some of them
    # zeros in another order: a few ulps of each gradient's scale
    for name, a, r in zip(("gx", "goff", "gw", "gb"), (got[0][..., :cin], got[1], got[2][..., :cin, :], got[3]), ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()), msg=name)
    # the padded channels get exactly zero gradient: their weight rows are
    # zero (no gcols) and their x is zero (no samples for gw)
    assert not got[0][..., cin:].any() and not got[2][..., cin:, :].any()


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin", CINS)
def test_split_operands_give_the_same_backward(cin, aperture):
    """The f32 route's weight planes add back to the packed weight within
    2^-21 of each entry, and through the plain backward hi + lo gives the
    gradients of the original operands."""
    x, off, w, bias, g = _operands(cin, seed=2)
    xp, planes = pack_deform_bwd_3xtf32(x, w)
    _, wpk = pack_deform_bwd(x, w)
    assert planes.shape == (2,) + wpk.shape and planes.is_contiguous() and planes.dtype == torch.float32
    assert bool(((planes[0] + planes[1] - wpk).abs() <= wpk.abs() * 2.0 ** -21).all())
    assert torch.equal(xp, pack_deform_bwd(x, w)[0])
    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture)
    got = deform_conv3d_bwd_plain(xp, off, _unpack(planes[0] + planes[1]), bias, g, aperture)
    for name, a, r in zip(("gx", "goff", "gw", "gb"), (got[0][..., :cin], got[1], got[2][..., :cin, :], got[3]), ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()), msg=name)
    assert not planes[:, :, cin:].any()  # padded input channels: zero in both planes


@pytest.mark.parametrize("cin", CINS)
def test_padding_is_exactly_zero(cin):
    x, _, w, _, _ = _operands(cin, seed=1)
    xp, wpk = pack_deform_bwd(x, w)
    cp = next(c for c in CP_WIDTHS if c >= cin)
    assert xp.shape == x.shape[:-1] + (cp,) and xp.is_contiguous()
    assert wpk.shape == (KTAPS, cp, 64) and wpk.is_contiguous() and wpk.dtype == w.dtype
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    assert torch.equal(wpk[:, :cin], w.reshape(KTAPS, cin, 64)) and not wpk[:, cin:].any()
    if cp == cin:
        assert xp is x  # no copy of an operand already laid out for the kernel
    # 16-byte rows: one TMA box row of the weight, 80 or 128 bytes of x in bf16
    assert wpk.stride(1) * 2 == 128 and (xp.shape[-1] * 2) % 16 == 0


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"), (torch.float32, "tensor_cores_3xtf32"),
                                         (torch.float16, None)])
def test_route_follows_the_dtype(dtype, route):
    if route is None:
        with pytest.raises(TypeError):
            bwd_route(dtype)
    else:
        assert bwd_route(dtype) == route


@pytest.mark.parametrize("shape,dtype,plan", [
    ((2, 4, 192, 144, 35), torch.bfloat16, ("tensor_cores", 40, 39)),  # the train path, 132 SMs
    ((2, 4, 192, 144, 64), torch.bfloat16, ("tensor_cores", 64, 39)),
    ((2, 4, 192, 144, 35), torch.float32, ("tensor_cores_3xtf32", 40, 39)),  # 64-voxel tiles
    ((1, 1, 2, 5, 35), torch.bfloat16, ("tensor_cores", 40, 1)),  # one tile: one share per tap
    ((3, 5, 1, 1, 64), torch.float32, ("tensor_cores_3xtf32", 64, 1)),
    ((2, 4, 192, 144, 96), torch.bfloat16, ("tensor_cores", 128, 39)),  # the wide form: whole chunks
    ((2, 4, 192, 144, 51), torch.float32, ("tensor_cores_3xtf32", 64, 39)),  # at Co 96 (below)
])
def test_bwd_plan(shape, dtype, plan):
    assert bwd_plan(shape, dtype, 132, co=96 if shape[-1] == 51 else 64) == plan


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin,co", [(15, 24), (51, 96), (96, 96), (131, 16)])
def test_wide_packed_operands_give_the_same_backward(cin, co, aperture):
    """The wide form's operands: x padded to whole chunks, the rows
    [27, CP, COP] (and their TF32 planes) with zero columns past Co, and
    the cotangent padded with zero columns, through the plain backward,
    give the original gradients; the padded channels get exactly zero."""
    x, off, w, bias, g = _operands(cin, co=co)
    wide, cp, cop = layout(cin, co)
    assert wide and cp % 64 == 0 and cop % 64 == 0
    xp, wpk = pack_deform_bwd(x, w)
    xs, planes = pack_deform_bwd_3xtf32(x, w)
    assert xp.shape[-1] == cp and wpk.shape == (KTAPS, cp, cop) and torch.equal(xs, xp)
    assert planes.shape == (2, KTAPS, cp, cop) and not planes[:, :, cin:].any() and not planes[..., co:].any()
    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture)
    gp = torch.nn.functional.pad(g, (0, cop - co))
    bias_p = torch.nn.functional.pad(bias, (0, cop - co))
    for rows in (wpk, planes[0] + planes[1]):
        got = deform_conv3d_bwd_plain(xp, off, _unpack(rows), bias_p, gp, aperture)
        for name, a, r in zip(("gx", "goff", "gw", "gb"),
                              (got[0][..., :cin], got[1], got[2][..., :cin, :co], got[3][:co]), ref):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()), msg=name)
        assert not got[0][..., cin:].any() and not got[2][..., cin:, :].any()


class _TensorOnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_either_route_raises_instead_of_falling_back(dtype, aperture):
    """Off the CPU, K2 launches the kernel of its route or raises: with no
    CUDA toolkit and no card here, every dtype and aperture raises and
    nothing is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensor could reach a kernel")
    x, off, w, bias, g = (torch.Tensor._make_subclass(_TensorOnCuda, t.to(dtype)) for t in _operands(35))
    before = launch_counts()
    with pytest.raises((RuntimeError, ValueError)):
        deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
    assert launch_counts() == before


def test_split_tool_patches_the_kernel_source():
    """`tools.bench_k2_split` compiles parts of K2 out by patching its
    source: every text it patches is in the tensor-core kernel's source
    exactly once, and each variant's macro lands in the patched source."""
    from dualpixelface_tpu_torch.ops.kernels import _build
    from dualpixelface_tpu_torch.tools import bench_k2_split as split

    kind, source = split.patched((_build.CSRC / "deform_conv3d_bwd.cu").read_text())
    assert kind == "tensor_cores"
    for flags in split.VARIANTS.values():
        for flag in flags:
            assert flag.removeprefix("-D") in source, flag
