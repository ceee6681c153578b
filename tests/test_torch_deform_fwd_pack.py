"""The host side of K1's routes (`ops/kernels/deform_fused.py`), on the CPU.

The bf16 route reads x with its channels padded to CP (40 or 64) and each
tap's weight rows packed as [27, KP, Co], KP = CP rounded up to the wgmma K
step of 16 (`pack_deform_fwd`); the kernel's A tile holds zeros in
channels CP..KP-1. The f32 route (3xTF32) reads the same padded x and each
tap's weight plane [Co, CP], K contiguous, split into TF32 hi and lo
(`pack_deform_fwd_3xtf32`). Through the plain forward, the packed operands
(x padded on to KP, as the A tile is; the hi plane transposed back) must
give exactly the unpacked output, and every padded entry must be exactly
zero. Which kernel a call takes follows its dtype alone (`fwd_route`); off
the CPU a call launches that kernel or raises, whatever the dtype and
aperture. Past the tuned widths (Cin <= CIN_TUNED at Co 64) the wide form
pads x to whole 64-channel chunks and Co to whole 64-wide N tiles, and
its packed operands too must give the unpacked output bit for bit."""
import numpy as np
import pytest
import torch

from dualpixelface_tpu_torch.ops.kernels import launch_counts
from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
    CHUNK, CIN_TUNED, CP_WIDTHS, KTAPS, deform_conv3d_fused, deform_conv3d_plain, fwd_route, fwd_weight_rows,
    layout, pack_deform_bwd, pack_deform_fwd, pack_deform_fwd_3xtf32)
from dualpixelface_tpu_torch.ops.kernels.split_f32 import split_planes
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

CINS = [3, 35, 40, 64]  # padded to 40, 40, 40 (as it is), 64 (as it is); rows 48, 48, 48, 64


# the wide form's widths (Cin, Co): the ANM's at inplanes 12 and 48, and
# chip_smoke.py's extremes
WIDE = [(15, 24), (24, 24), (51, 96), (96, 96), (131, 16), (3, 128)]


def _operands(cin, seed=0, shape=(2, 3, 5, 4), co=64):
    """Values on which every sum of the plain forward is exact in f32, in
    any order: x and the weight small integers, the offsets multiples of
    1/4 (so each corner weight is a multiple of 1/64) in [-6, 2.75], which
    the aperture clamps at its lower bound (a whole number) and never at
    its upper one. So the packed and the unpacked operands must agree bit
    for bit, whatever order the product's sums take."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, shape + (cin,))
    off = rng.integers(-24, 12, shape + (81,)) / 4.0
    w = rng.integers(-2, 3, (3, 3, 3, cin, co))
    bias = rng.integers(-4, 5, (co,))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in (x, off, w, bias)]


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin", CINS)
def test_packed_operands_give_the_same_forward(cin, aperture):
    x, off, w, bias = _operands(cin)
    xp, wpk = pack_deform_fwd(x, w)
    kp = wpk.shape[1]
    # the A tile's channels past CP are zero: x padded on to KP
    xk = torch.nn.functional.pad(xp, (0, kp - xp.shape[-1]))
    got = deform_conv3d_plain(xk, off, wpk.reshape(3, 3, 3, kp, 64), bias, aperture)
    ref = deform_conv3d_plain(x, off, w, bias, aperture)
    assert ref.abs().max() > 1.0  # the data reach the sums
    assert torch.equal(got, ref)


def test_aperture_changes_the_operands_output():
    """The offsets of `_operands` reach past the window, so the two
    apertures sample differently (the test above checks both)."""
    x, off, w, bias = _operands(35)
    assert not torch.equal(deform_conv3d_plain(x, off, w, bias, True), deform_conv3d_plain(x, off, w, bias, False))


@pytest.mark.parametrize("cin", CINS)
def test_padding_is_exactly_zero(cin):
    x, _, w, _ = _operands(cin, seed=1)
    xp, wpk = pack_deform_fwd(x, w)
    cp = next(c for c in CP_WIDTHS if c >= cin)
    kp = fwd_weight_rows(cin)
    assert xp.shape == x.shape[:-1] + (cp,) and xp.is_contiguous()
    assert wpk.shape == (KTAPS, kp, 64) and wpk.is_contiguous() and wpk.dtype == w.dtype
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    assert torch.equal(wpk[:, :cin], w.reshape(KTAPS, cin, 64)) and not wpk[:, cin:].any()
    if cp == cin:
        assert xp is x  # no copy of an operand already laid out for the kernel
    # one TMA box row of the weight is 128 bytes in bf16, a tap's rows fill
    # whole 1024-byte ring slots, and x's rows are 80 or 128 bytes
    assert wpk.stride(1) * 2 == 128 and (kp * 128) % 1024 == 0 and (xp.shape[-1] * 2) % 16 == 0


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin", CINS)
def test_split_planes_give_the_same_forward(cin, aperture):
    """The f32 route's hi plane, transposed back to the taps' rows, is the
    weight (small integers keep no bit below TF32's mantissa, so lo is
    zero): through the plain forward on the padded x it gives the unpacked
    output bit for bit."""
    x, off, w, bias = _operands(cin)
    xp, wpk = pack_deform_fwd_3xtf32(x, w)
    cp = xp.shape[-1]
    assert not wpk[1].any()
    got = deform_conv3d_plain(xp, off, wpk[0].transpose(1, 2).reshape(3, 3, 3, cp, 64), bias, aperture)
    ref = deform_conv3d_plain(x, off, w, bias, aperture)
    assert ref.abs().max() > 1.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cin", CINS)
def test_split_planes_layout(cin):
    """[2, 27, Co, KP], K contiguous, KP = CP (a whole number of the TF32 K
    step of 8); hi and lo are `split_planes` of the transposed tap rows,
    exactly zero past Cin; x padded as K2's f32 route pads it."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 4, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, cin, 64)) / np.sqrt(27 * cin)).astype(np.float32))
    xp, wpk = pack_deform_fwd_3xtf32(x, w)
    cp = next(c for c in CP_WIDTHS if c >= cin)
    assert wpk.shape == (2, KTAPS, 64, cp) and wpk.is_contiguous() and wpk.stride(-1) == 1 and cp % 8 == 0
    rows = torch.nn.functional.pad(w.reshape(KTAPS, cin, 64), (0, 0, 0, cp - cin))
    assert torch.equal(wpk, split_planes(rows.transpose(1, 2).contiguous()))
    assert wpk[1].any() and not wpk[:, :, :, cin:].any()
    assert torch.equal(wpk[0] + wpk[1], (wpk[0].double() + wpk[1].double()).float())  # hi + lo exact in f32
    assert torch.equal(xp, pack_deform_bwd(x, w)[0])
    # a TMA box row of a plane is 128 bytes (32 f32): a row of KP f32 is a
    # whole number of 16-byte steps, as the tensor map's stride must be
    assert (cp * 4) % 16 == 0 and (xp.shape[-1] * 4) % 16 == 0


@pytest.mark.parametrize("cin,rows", [(1, 48), (3, 48), (35, 48), (40, 48), (41, 64), (64, 64), (65, 128), (131, 192)])
def test_weight_rows_are_whole_k_steps(cin, rows):
    assert fwd_weight_rows(cin) == rows and rows % 16 == 0


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"), (torch.float32, "tensor_cores_3xtf32"),
                                         (torch.float16, None)])
def test_route_follows_the_dtype(dtype, route):
    if route is None:
        with pytest.raises(TypeError):
            fwd_route(dtype)
    else:
        assert fwd_route(dtype) == route


class _TensorOnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_either_route_raises_instead_of_falling_back(dtype, aperture):
    """Off the CPU, K1 launches the kernel of its route or raises: with no
    CUDA toolkit and no card here, every dtype and aperture raises and
    nothing is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensor could reach a kernel")
    x, off, w, bias = (torch.Tensor._make_subclass(_TensorOnCuda, t.to(dtype)) for t in _operands(35))
    before = launch_counts()
    with pytest.raises((RuntimeError, ValueError)):
        deform_conv3d_fused(x, off, w, bias, aperture=aperture)
    assert launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_more_than_cin_max_channels_raise(dtype):
    """More than the tuned forms' CIN_TUNED input channels (and another Co)
    are no longer refused for their width: a CUDA call gets past every
    check of its operands and fails only where it needs CUDA, before
    anything is packed, launched or counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensor could reach a kernel")
    x, off, w, bias = _operands(CIN_TUNED + 1, shape=(1, 1, 2, 2), co=96)
    x, off, w, bias = (torch.Tensor._make_subclass(_TensorOnCuda, t.to(dtype)) for t in (x, off, w, bias))
    before = launch_counts()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deform_conv3d_fused(x, off, w, bias)
    assert launch_counts() == before


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin,co", WIDE)
def test_wide_packed_operands_give_the_same_forward(cin, co, aperture):
    """The wide form's operands, both routes': x padded to CP (whole
    chunks), the bf16 rows [27, CP, COP] and the f32 hi plane transposed
    back, through the plain forward, give the unpacked output bit for bit
    in its first Co channels and exact zeros past them; every padded entry
    is zero."""
    x, off, w, bias = _operands(cin, co=co)
    wide, cp, cop = layout(cin, co)
    assert wide and cp % CHUNK == 0 and cp >= cin and cop % 64 == 0 and cop >= co
    ref = deform_conv3d_plain(x, off, w, bias, aperture)
    assert ref.abs().max() > 1.0
    bias_p = torch.nn.functional.pad(bias, (0, cop - co))
    xp, wpk = pack_deform_fwd(x, w)
    assert xp.shape[-1] == cp and wpk.shape == (KTAPS, fwd_weight_rows(cin, co), cop) == (KTAPS, cp, cop)
    assert not xp[..., cin:].any() and not wpk[:, cin:].any() and not wpk[:, :, co:].any()
    got = deform_conv3d_plain(xp, off, wpk.reshape(3, 3, 3, cp, cop), bias_p, aperture)
    assert torch.equal(got[..., :co], ref) and not got[..., co:].any()
    xs, planes = pack_deform_fwd_3xtf32(x, w)
    assert torch.equal(xs, xp) and planes.shape == (2, KTAPS, cop, cp) and not planes[1].any()
    got = deform_conv3d_plain(xs, off, planes[0].transpose(1, 2).reshape(3, 3, 3, cp, cop), bias_p, aperture)
    assert torch.equal(got[..., :co], ref)


def test_split_tool_patches_the_kernel_source():
    """`tools.bench_k1_split` compiles parts of K1 out by patching its
    source: every text it patches is in the source exactly once, the f32
    route's load of x and its contraction as well as the bf16 route's, and
    each variant's macro lands in the patched source."""
    from dualpixelface_tpu_torch.ops.kernels import _build
    from dualpixelface_tpu_torch.tools import bench_k1_split as split

    source = split.patched((_build.CSRC / "deform_conv3d.cu").read_text())
    for flags in (*split.VARIANTS.values(), *split.F32_VARIANTS.values()):
        for flag in flags:
            assert flag.removeprefix("-D") in source, flag
    f32_kernel = source[source.index("deform_fwd_3xtf32_kernel("):]
    assert "xr[q] = K1_X_LOAD4(q);" in f32_kernel
    assert "if (!NO_CONTRACTION_FLAG) tc::mma_3xtf32<CO>(acc, " in f32_kernel
    assert set(split.SYMBOLS.values()) == {"dpf_deform_conv3d_tc", "dpf_deform_conv3d_3xtf32"}
