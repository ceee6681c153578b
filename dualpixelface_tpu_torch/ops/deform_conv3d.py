"""3-D deformable convolution (counterpart of
`dualpixelface_tpu/ops/deform_conv3d.py`, the reference's `dcn3d`
extension: "D3D"), channels-last.

`deform_conv3d` samples x trilinearly at base + offset (deformable conv
v1: base = out * stride - pad + tap * dilation, zero outside the volume)
and contracts the samples with the weight, plus bias. Its route depends on
the geometry alone, and is chosen before anything is launched:

  * 3x3x3, stride 1, pad 1, dilation 1 (the ANM's): `deform_conv3d_fused`,
    kernel K1 on the card (K2 for the backward), at any width; its plain
    version on the CPU. impl 'simple', 'packed' and 'packed8' are the
    unbounded sampling (the reference's), 'pallas' the windowed one (the
    H/W positions clamped to the +-AP window, the TPU kernel's semantics),
    as is `aperture` with 'packed' or 'packed8'; `gather_chunks` changes
    nothing there. A K1 or K2 build or launch failure raises.
  * every other geometry: the plain gather and one `torch.matmul` per
    chunk of output voxels (`gather_chunks`), as the JAX package runs it
    outside any Pallas kernel (an XLA gather and `dot_general`), on the
    card and on the CPU alike; the backward recomputes the samples, as
    JAX's `jax.checkpoint` does. `aperture` clamps there as JAX's
    `_deform_conv3d_packed` does, around the output voxel's (h, w); impl
    'pallas' is refused (JAX's `DeformConvPack3D` sends it to 'packed8'
    outside the ANM geometry).

The modules, under the reference's state_dict names (`weight` [Cout, Cin,
kd, kh, kw], `bias`, `conv_offset.*`): `DeformConvPack3D` predicts its own
offsets (reference DeformConvPack_dv2, dimension 'THW'; its offset head
runs through kernel K5 at the ANM geometry, through cuDNN's conv3d at any
other, as JAX runs an XLA conv there) and returns (output, offset);
`DeformConv3D` takes the offsets from its caller (reference DeformConv /
DeformConv_d), `DeformConvPack3D_d` predicts len(dimension) x K of them
with a zero-initialised `nn.Conv3d` (reference DeformConvPack_d); with a
`dimension` short of 'THW' the missing axes' offsets are zero
(`expand_masked_offset`).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice
from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
    AP, EPS, KTAPS, clamp_positions, deform_conv3d_fused, sample_cols)

IMPLS = ("simple", "packed", "packed8", "pallas")


def _triple(v) -> tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def route(kernel_size, stride=1, padding=1, dilation=1) -> str:
    """"kernels" (K1/K2 through `deform_conv3d_fused`) at the ANM geometry,
    3x3x3 / stride 1 / pad 1 / dilation 1; "plain" (gather + matmul) at
    any other."""
    anm = (_triple(kernel_size), _triple(stride), _triple(padding), _triple(dilation)) == ((3, 3, 3),) + ((1, 1, 1),) * 3
    return "kernels" if anm else "plain"


def deform_conv3d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int | Sequence[int] = 1,
    padding: int | Sequence[int] = 1,
    dilation: int | Sequence[int] = 1,
    impl: str = "packed8",
    aperture: bool = False,
    gather_chunks: int = 1,
) -> torch.Tensor:
    """x [B, D, H, W, Cin]; offset [B, Do, Ho, Wo, 3K], per tap k =
    (kd KH + kh) KW + kw the triple (dD, dH, dW) at channels 3k..3k+2;
    weight [KD, KH, KW, Cin, Cout]; bias [Cout] or None. Returns
    [B, Do, Ho, Wo, Cout] in x's dtype; differentiable. The route follows
    the geometry (module docstring, `route`)."""
    if impl not in IMPLS:
        raise ValueError(f"deform impl {impl!r} not in {IMPLS}")
    st, pad, dil = _triple(stride), _triple(padding), _triple(dilation)
    ks = tuple(weight.shape[:3])
    if weight.ndim != 5 or x.ndim != 5 or weight.shape[3] != x.shape[-1]:
        raise ValueError(f"x {tuple(x.shape)} and weight {tuple(weight.shape)} must be [B, D, H, W, Cin] and "
                         f"[KD, KH, KW, Cin, Cout]")
    k = math.prod(ks)
    out_dhw = tuple((n + 2 * p - q * (kk - 1) - 1) // s + 1
                    for n, p, q, kk, s in zip(x.shape[1:4], pad, dil, ks, st))
    if offset.shape != x.shape[:1] + out_dhw + (3 * k,):
        raise ValueError(f"offset {tuple(offset.shape)} must be {x.shape[:1] + out_dhw + (3 * k,)}")
    windowed = impl == "pallas" or (aperture and impl != "simple")
    if route(ks, st, pad, dil) == "kernels":
        return deform_conv3d_fused(x, offset, weight, bias, aperture=windowed)
    if impl == "pallas":
        raise ValueError("deform impl 'pallas' takes the 3x3x3 / stride 1 / pad 1 geometry only")
    return _PlainDeformConv3d.apply(x, offset, weight, bias, (st, pad, dil), windowed, max(1, int(gather_chunks)))


def _chunks(n: int, chunks: int):
    """`chunks` slices of [0, n), equal but the last."""
    step = -(-n // chunks)
    return [slice(n0, min(n, n0 + step)) for n0 in range(0, n, step)]


def _plain_chunk(x, off_chunk, weight, geometry, aperture, out_dhw, sl):
    """The plain route on the output voxels `sl` (flat over out_dhw), off_chunk
    [B, n_c, 3K] their offsets: the samples summed in f32 and rounded to x's
    dtype, one f32 matmul with the weight rounded to x's dtype (K1's plain
    version's rounding points), no bias: [B, n_c, Cout]."""
    st, pad, dil = geometry
    b = x.shape[0]
    kd, kh, kw, c, co = weight.shape
    k = kd * kh * kw
    dev, f32 = x.device, torch.float32
    zz, yy, xx = torch.meshgrid(*(torch.arange(m, device=dev) for m in out_dhw), indexing="ij")
    kz, ky, kx = torch.meshgrid(*(torch.arange(m, device=dev) for m in (kd, kh, kw)), indexing="ij")
    off = off_chunk.reshape(b, -1, k, 3).to(f32)
    pos = [(o.reshape(-1, 1)[sl] * s - p + t.reshape(1, -1) * q).to(f32) + off[..., a]  # [B, n_c, K]
           for a, (o, t, s, p, q) in enumerate(zip((zz, yy, xx), (kz, ky, kx), st, pad, dil))]
    if aperture:  # around the output voxel's (h, w), as JAX's _deform_conv3d_packed clamps
        pos[1] = clamp_positions(pos[1], yy.reshape(1, -1, 1)[:, sl].to(f32))
        pos[2] = clamp_positions(pos[2], xx.reshape(1, -1, 1)[:, sl].to(f32))
    cols = sample_cols(x, *pos).to(x.dtype)
    return (cols.reshape(-1, k * c).float() @ weight.reshape(k * c, co).float()).to(x.dtype).reshape(b, -1, co)


class _PlainDeformConv3d(torch.autograd.Function):
    """The plain route, one chunk of output voxels at a time; the backward
    recomputes each chunk from the saved inputs (no samples kept between
    the passes)."""

    @staticmethod
    def forward(ctx, x, offset, weight, bias, geometry, aperture, chunks):
        ctx.save_for_backward(x, offset, weight, bias)
        ctx.args = geometry, aperture, chunks
        b, do, ho, wo = offset.shape[:4]
        off = offset.reshape(b, do * ho * wo, -1)
        out = torch.cat([_plain_chunk(x, off[:, sl], weight, geometry, aperture, (do, ho, wo), sl)
                         for sl in _chunks(do * ho * wo, chunks)], dim=1)
        if bias is not None:
            out = out + bias.to(x.dtype)
        return out.reshape(b, do, ho, wo, -1)

    @staticmethod
    def backward(ctx, g):
        x, offset, weight, bias = ctx.saved_tensors
        geometry, aperture, chunks = ctx.args
        b, do, ho, wo, co = g.shape
        n = do * ho * wo
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        gw = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
        goff = torch.empty(offset.shape, dtype=offset.dtype, device=offset.device)
        off, goff_flat, g_flat = offset.reshape(b, n, -1), goff.view(b, n, -1), g.reshape(b, n, co)
        with torch.enable_grad():
            xl, wl = x.detach().requires_grad_(True), weight.detach().requires_grad_(True)
            for sl in _chunks(n, chunks):
                ol = off[:, sl].detach().requires_grad_(True)
                out = _plain_chunk(xl, ol, wl, geometry, aperture, (do, ho, wo), sl)
                dx, doff, dw = torch.autograd.grad(out, (xl, ol, wl), g_flat[:, sl])
                gx += dx.float()
                gw += dw.float()
                goff_flat[:, sl] = doff
        gb = None if bias is None else g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(bias.dtype)
        return gx.to(x.dtype), goff, gw.to(weight.dtype), gb, None, None, None


def expand_masked_offset(temp: torch.Tensor, dimension: str, k: int) -> torch.Tensor:
    """temp [..., len(dimension) K], tap-major (tap i's components at
    channels i len + j, j over the active axes in T, H, W order; `dimension`
    any subset of 'THW', in any order) -> [..., 3K] in `deform_conv3d`'s
    layout, the missing axes' offsets zero (ref modules/deform_conv.py
    DeformConv_d)."""
    active = [i for i, ax in enumerate("THW") if ax in dimension]
    length = len(active)
    if temp.shape[-1] != length * k:
        raise ValueError(f"offset channels {temp.shape[-1]} != {length} x {k} taps for dimension {dimension!r}")
    if length == 3:
        return temp
    t = temp.reshape(temp.shape[:-1] + (k, length))
    zero = torch.zeros_like(t[..., 0])
    parts = [t[..., active.index(axis)] if axis in active else zero for axis in range(3)]
    return torch.stack(parts, dim=-1).reshape(temp.shape[:-1] + (3 * k,))


def clamp_offsets_to_window(offset: torch.Tensor) -> torch.Tensor:
    """Clamp predicted offsets so every H/W sampling position lies inside
    the +-AP window: per tap, dH in [-AP - (kh-1), AP + 1 - EPS - (kh-1)],
    likewise dW with kw; dD unbounded. The forward value is
    offset + (clipped - offset) and the gradient is straight-through (the
    identity), as in the JAX package: a clipped offset keeps receiving the
    window-interior signal."""
    if offset.shape[-1] != 3 * KTAPS:
        raise ValueError(f"offset channels {offset.shape[-1]} != {3 * KTAPS}")
    lo, hi = _window_bounds(offset.device, offset.dtype)
    clipped = torch.minimum(torch.maximum(offset, lo), hi)
    return offset + (clipped - offset).detach()


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _window_bounds(device, dtype):
    """Per-channel (lo, hi) offset bounds of `clamp_offsets_to_window`, on
    the device once (a per-call host copy would drain the stream). Callers
    only read them."""
    kz, ky, kx = np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij")
    base_h = ky.reshape(-1) - 1
    base_w = kx.reshape(-1) - 1
    big = np.float32(1e9)
    lo = np.stack([-big * np.ones(KTAPS), -AP - base_h, -AP - base_w], -1).reshape(3 * KTAPS)
    hi = np.stack([big * np.ones(KTAPS), AP + 1 - EPS - base_h, AP + 1 - EPS - base_w], -1).reshape(3 * KTAPS)
    return tuple(torch.as_tensor(a, device=device).to(dtype) for a in (lo, hi))


class _DeformBase(nn.Module):
    """`weight` [Cout, Cin, kd, kh, kw] and `bias` [Cout] (or None), torch's
    default conv init, U(+-1/sqrt(fan_in)) as the JAX package's
    `_torch_kaiming_uniform`."""

    def __init__(self, in_ch, features, kernel_size, stride, padding, dilation, use_bias, impl):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"deform impl {impl!r} not in {IMPLS}")
        self.kernel_size = _triple(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.impl = impl
        self.weight = nn.Parameter(torch.empty((features, in_ch) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        bound = 1.0 / math.sqrt(in_ch * math.prod(self.kernel_size))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound)
            if self.bias is not None:
                nn.init.uniform_(self.bias, -bound, bound)

    @property
    def taps(self) -> int:
        return math.prod(self.kernel_size)

    def _deform(self, x, offset, impl, gather_chunks=1):
        dt = x.dtype
        weight = self.weight.permute(2, 3, 4, 1, 0).contiguous().to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        return deform_conv3d(x, offset, weight, bias, self.stride, self.padding, self.dilation, impl=impl,
                             gather_chunks=gather_chunks)

    def _offset_conv(self, x):
        """The offset head on channels-last x, by cuDNN's conv3d (NCDHW)."""
        conv = self.conv_offset
        y = torch.nn.functional.conv3d(torch.movedim(x, -1, 1), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                                       conv.stride, conv.padding)
        return torch.movedim(y, 1, -1).contiguous()


class DeformConvPack3D(_DeformBase):
    """Self-offset-predicting deformable conv (reference DeformConvPack_dv2,
    dimension 'THW'), channels-last [B, D, H, W, C]; returns (output,
    offset). Positional arguments as the ANM builds it: (in_ch, features,
    impl, offset_clamp); the rest as JAX's module: `kernel_size`, `stride`,
    `padding`, `use_bias`, `gather_chunks`, and `maxsize`, accepted and
    unused (the reference's clamp is commented out).

    At the ANM geometry the offset head (81 channels, any Cin) runs through
    kernel K5 and the conv through K1; impl 'pallas' is windowed there when
    D <= 4 (the JAX package's rule: its TPU kernel held at most 4 planes)
    and unbounded otherwise, as 'packed8' always is; `offset_clamp` clamps
    the predicted offsets to the window first (`clamp_offsets_to_window`).
    At any other geometry the head is an `nn.Conv3d` run by cuDNN, the conv
    takes the plain route, 'pallas' becomes 'packed8' and `offset_clamp`
    does nothing, as in JAX."""

    def __init__(self, in_ch: int, features: int, impl: str = "pallas", offset_clamp: bool = False,
                 kernel_size=3, stride: int = 1, padding: int = 1, maxsize: float | None = None,
                 use_bias: bool = True, gather_chunks: int = 1):
        if impl not in ("pallas", "packed8"):
            raise ValueError(f"deform impl {impl!r} not in ('pallas', 'packed8')")
        super().__init__(in_ch, features, kernel_size, stride, padding, 1, use_bias, impl)
        self.offset_clamp = offset_clamp
        self.gather_chunks = gather_chunks
        self.anm = route(self.kernel_size, stride, padding) == "kernels"
        self.conv_offset = nn.Conv3d(in_ch, 3 * self.taps, self.kernel_size, stride, padding, bias=True)
        with torch.no_grad():  # zero-initialised, as in JAX and the reference
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x: torch.Tensor):
        dt = x.dtype
        if self.anm:
            w_off = self.conv_offset.weight.permute(2, 3, 4, 1, 0).contiguous().to(dt)
            offset = conv3d_dslice(x, w_off, self.conv_offset.bias.to(dt))
            if self.offset_clamp:
                offset = clamp_offsets_to_window(offset)
        else:
            offset = self._offset_conv(x)
        impl = "pallas" if self.impl == "pallas" and self.anm and x.shape[1] <= 4 else "packed8"
        return self._deform(x, offset, impl, self.gather_chunks), offset


class DeformConv3D(_DeformBase):
    """Deformable conv with offsets from the caller (reference DeformConv;
    with `dimension` short of 'THW' reference DeformConv_d: the offset
    argument then carries len(dimension) x K channels, tap-major, and the
    missing axes' offsets are zero). `maxsize` is accepted and unused."""

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1, padding=1, dilation=1,
                 dimension: str = "THW", maxsize: float | None = None, use_bias: bool = True, impl: str = "packed8"):
        super().__init__(in_ch, features, kernel_size, stride, padding, dilation, use_bias, impl)
        self.dimension = dimension

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return self._deform(x, expand_masked_offset(offset, self.dimension, self.taps), self.impl)


class DeformConvPack3D_d(_DeformBase):
    """Dimension-masked self-offset-predicting deformable conv (reference
    DeformConvPack_d): a zero-initialised `nn.Conv3d` (`conv_offset`, run
    by cuDNN) predicts len(dimension) x K offsets, expanded with the missing
    axes at zero. Returns the output only, as the reference does. `maxsize`
    is accepted and unused."""

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1, padding=1, dimension: str = "THW",
                 maxsize: float | None = None, use_bias: bool = True, impl: str = "packed8"):
        super().__init__(in_ch, features, kernel_size, stride, padding, 1, use_bias, impl)
        self.dimension = dimension
        length = len([ax for ax in "THW" if ax in dimension])
        self.conv_offset = nn.Conv3d(in_ch, length * self.taps, self.kernel_size, stride, padding, bias=True)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offset = expand_masked_offset(self._offset_conv(x), self.dimension, self.taps)
        return self._deform(x, offset, self.impl)
