"""The host-side layout of the tensor-core 3x3x3 conv (K5 and T1 in bf16,
K5 in f32), on the CPU. bf16 (`conv3d_dslice.pack_conv3d`): x's channels
padded to a multiple of 8, the weight packed as [N, Kp] with K contiguous.
f32 (`pack_conv3d_3xtf32`): x's channels padded to a multiple of 4, the
packed weight (Kp a multiple of 32) split into two TF32 planes [2, N, Kp].
Unpacked back into [3, 3, 3, Cp, N], the packed operands must give
`conv3d_f32` of the original ones, and every padded row and column must be
exactly zero."""
import numpy as np
import pytest
import torch

from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import (
    BK, BK_F32, N_PAD, conv3d_f32, pack_conv3d, pack_conv3d_3xtf32, route)
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

# (Co, N): K5's offset heads padded to eleven n8 tiles; T1's widths as they are
WIDTHS = [(81, N_PAD), (32, 32), (64, 64)]
CINS = [35, 64]


def _operands(cin, co, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 5, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, cin, co)) * 0.1).astype(np.float32))
    return x, w


@pytest.mark.parametrize("co,n", WIDTHS)
@pytest.mark.parametrize("cin", CINS)
def test_packed_operands_give_the_same_conv(cin, co, n):
    x, w = _operands(cin, co)
    xp, wt = pack_conv3d(x, w, n)
    cp = xp.shape[-1]
    unpacked = wt[:, :27 * cp].t().reshape(3, 3, 3, cp, n)
    got = conv3d_f32(xp, unpacked)[..., :co]
    ref = conv3d_f32(x, w)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("co,n", WIDTHS)
@pytest.mark.parametrize("cin", CINS)
def test_padding_is_exactly_zero(cin, co, n):
    x, w = _operands(cin, co, seed=1)
    xp, wt = pack_conv3d(x, w, n)
    cp = -(-cin // 8) * 8
    kp = -(-27 * cp // BK) * BK
    assert xp.shape == x.shape[:-1] + (cp,) and xp.is_contiguous()
    assert wt.shape == (n, kp) and wt.is_contiguous() and wt.dtype == w.dtype
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    taps = wt[:, :27 * cp].reshape(n, 27, cp)
    assert torch.equal(taps[:co, :, :cin], w.reshape(27, cin, co).permute(2, 0, 1))
    assert not taps[:, :, cin:].any()  # padded input channels
    assert not wt[co:].any()  # columns past Co
    assert not wt[:, 27 * cp:].any()  # K past 27 Cp


@pytest.mark.parametrize("cin", CINS + [36, 40])
def test_f32_packed_planes_give_the_same_conv(cin):
    """hi + lo of the f32 route's planes unpack to the conv of the original
    operands (each entry within 2^-21 of the weight's)."""
    x, w = _operands(cin, 81, seed=3)
    xp, planes = pack_conv3d_3xtf32(x, w, N_PAD)
    cp = xp.shape[-1]
    whole = planes[0] + planes[1]
    assert bool(((whole[:81, :27 * cp].t().reshape(3, 3, 3, cp, 81)[..., :cin, :] - w).abs()
                 <= w.abs() * 2.0 ** -21).all())
    got = conv3d_f32(xp, whole[:, :27 * cp].t().reshape(3, 3, 3, cp, N_PAD))[..., :81]
    ref = conv3d_f32(x, w)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("cin", CINS + [36, 40])
def test_f32_padding_is_exactly_zero(cin):
    x, w = _operands(cin, 81, seed=4)
    xp, planes = pack_conv3d_3xtf32(x, w, N_PAD)
    cp = -(-cin // 4) * 4
    kp = -(-27 * cp // BK_F32) * BK_F32
    assert xp.shape == x.shape[:-1] + (cp,) and xp.is_contiguous()
    assert planes.shape == (2, N_PAD, kp) and planes.is_contiguous() and planes.dtype == torch.float32
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    if cp == cin:
        assert xp is x
    taps = planes[:, :, :27 * cp].reshape(2, N_PAD, 27, cp)
    assert not taps[:, :, :, cin:].any()  # padded input channels
    assert not planes[:, 81:].any()  # columns past Co
    assert not planes[:, :, 27 * cp:].any()  # K past 27 Cp
    # rows of 16-byte granules for cp.async: x's rows and the planes' Kp
    assert (cp * 4) % 16 == 0 and (kp * 4) % 128 == 0


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "tensor_cores"), (torch.float32, "tensor_cores_3xtf32"),
                                        (torch.float16, None)])
def test_route_follows_the_dtype(dtype, name):
    if name is None:
        with pytest.raises(TypeError):
            route(dtype)
    else:
        assert route(dtype) == name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_keeps_aligned_operands(dtype):
    """At C % 8 == 0 x goes through untouched; the packed weight keeps the
    dtype and its rows are whole BK tiles (16-byte aligned for cp.async)."""
    x, w = _operands(64, 64)
    x, w = x.to(dtype), w.to(dtype)
    xp, wt = pack_conv3d(x, w, 64)
    assert xp is x
    assert wt.dtype == dtype and wt.shape[1] % BK == 0 and wt.stride(0) * wt.element_size() % 16 == 0


@pytest.mark.parametrize("layout", ["ncdhw", "channels_last_3d"])
def test_cudnn_yardstick_computes_the_same_conv(layout):
    """The library call timed beside K5 and T1 (`tools.cudnn_conv3d_calls`)
    is the same 3x3x3 pad-1 conv in each layout, its output NCDHW-shaped."""
    from dualpixelface_tpu_torch.tools import cudnn_conv3d_calls

    x, w = _operands(35, 81, seed=2)
    bias = torch.linspace(-1.0, 1.0, 81)
    got = cudnn_conv3d_calls(x, w, bias)[layout]().permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, conv3d_f32(x, w) + bias, rtol=1e-5, atol=1e-5)
