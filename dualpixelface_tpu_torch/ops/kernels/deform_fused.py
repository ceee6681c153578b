"""K1: deformable 3x3x3 convolution, stride 1, pad 1, NDHWC (the ANM
deform convs), windowed or unbounded.

Replaces the TPU kernel `deform_conv3d_fused` -> `_fused_call` in
`dualpixelface_tpu/ops/kernels/deform_fused.py`. On the TPU the sampling
had to be one-hot matmuls over a +-3 voxel window; on the card it is a
gather (`csrc/deform_conv3d.cu`, source note there), so one kernel serves
both semantics through `aperture`:

  * aperture=True: H/W sampling positions clamped to
    [out - AP, out + AP + 1 - EPS] (`clamp_positions`), the TPU kernel's
    windowed semantics (`deform_impl='pallas'`);
  * aperture=False: unbounded, the reference's sampling (`packed8`).

`deform_conv3d_fused` takes the plain PyTorch version for tensors on the
CPU and the kernel for CUDA tensors; anything else raises, as does a CUDA
call with other than CO output channels (the one width the kernel is built
for).
`deform_conv3d_fused.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from dualpixelface_tpu_torch.ops.kernels import _build

AP = 3               # aperture: +-AP voxels around the output voxel (H, W)
EPS = 1.0 / 1024.0
KTAPS = 27
CO = 64              # the kernel's output channels: the ANM deform convs', its only caller


def clamp_positions(pos: torch.Tensor, out_coord: torch.Tensor) -> torch.Tensor:
    """The aperture clamp, in f32: pos in [out - AP, out + AP + 1 - EPS]."""
    return torch.minimum(torch.maximum(pos, out_coord - AP), out_coord + AP + 1 - EPS)


def deform_conv3d_plain(x, offset, weight, bias=None, aperture=False):
    """x [B, D, H, W, C], offset [B, D, H, W, 81] (tap k = (kd*3+kh)*3+kw,
    channels k*3 + (dD, dH, dW)), weight [3, 3, 3, C, Co] -> [B, D, H, W, Co].

    Positions are base + offset in f32; trilinear samples with zero-valued
    corners outside the volume, summed in f32 and rounded to x's dtype; one
    f32 product against the weight, rounded to x's dtype; the bias is then
    added in that dtype."""
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    dev = x.device
    f32 = torch.float32
    zz, yy, xx = torch.meshgrid(
        torch.arange(d, device=dev), torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    kz, ky, kx = torch.meshgrid(*(torch.arange(3, device=dev),) * 3, indexing="ij")
    base_d = (zz.reshape(-1, 1) - 1 + kz.reshape(1, -1)).to(f32)  # [N, 27]
    base_h = (yy.reshape(-1, 1) - 1 + ky.reshape(1, -1)).to(f32)
    base_w = (xx.reshape(-1, 1) - 1 + kx.reshape(1, -1)).to(f32)
    n = d * h * w
    off = offset.reshape(b, n, KTAPS, 3).to(f32)
    pos_d = base_d + off[..., 0]  # [B, N, 27]
    pos_h = base_h + off[..., 1]
    pos_w = base_w + off[..., 2]
    if aperture:
        pos_h = clamp_positions(pos_h, yy.reshape(1, -1, 1).to(f32))
        pos_w = clamp_positions(pos_w, xx.reshape(1, -1, 1).to(f32))
    d0, h0, w0 = torch.floor(pos_d), torch.floor(pos_h), torch.floor(pos_w)
    fd, fh, fw = pos_d - d0, pos_h - h0, pos_w - w0

    x_flat = x.reshape(b * n, c)
    batch_base = (torch.arange(b, device=dev) * n).reshape(b, 1, 1)
    cols = torch.zeros((b, n, KTAPS, c), dtype=f32, device=dev)
    for cz in (0, 1):
        zi, wz = d0 + cz, (fd if cz else 1.0 - fd)
        for cy in (0, 1):
            yi, wy = h0 + cy, (fh if cy else 1.0 - fh)
            for cx in (0, 1):
                xi, wx = w0 + cx, (fw if cx else 1.0 - fw)
                ok = (zi >= 0) & (zi <= d - 1) & (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
                wgt = torch.where(ok, wz * wy * wx, torch.zeros((), dtype=f32, device=dev))
                lin = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
                idx = (lin.long() + batch_base).reshape(-1)
                cols += wgt[..., None] * x_flat.index_select(0, idx).reshape(b, n, KTAPS, c).to(f32)
    cols = cols.to(x.dtype).reshape(b * n, KTAPS * c)
    out = (cols.float() @ weight.reshape(KTAPS * c, co).float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.reshape(b, d, h, w, co)


def _lib():
    lib = _build.load("deform_conv3d")
    fn = lib.dpf_deform_conv3d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def deform_conv3d_fused(x, offset, weight, bias=None, aperture=True):
    """Deformable 3x3x3 conv, stride 1, pad 1. CPU tensors: the plain
    version. CUDA tensors: the K1 kernel, or an error."""
    if x.ndim != 5 or offset.shape != x.shape[:4] + (3 * KTAPS,) or weight.shape[:4] != (3, 3, 3, x.shape[-1]):
        raise ValueError(
            f"deform_conv3d_fused: x {tuple(x.shape)}, offset {tuple(offset.shape)}, weight "
            f"{tuple(weight.shape)} must be [B, D, H, W, C], [B, D, H, W, 81], [3, 3, 3, C, Co]"
        )
    if x.device.type == "cpu":
        return deform_conv3d_plain(x, offset, weight, bias, aperture)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv3d_fused: no kernel for device {x.device}")
    co = weight.shape[-1]
    if co != CO:
        raise ValueError(f"deform_conv3d_fused: the kernel takes Co = {CO} output channels, not {co}")
    _build.check_cuda_tensors("deform_conv3d_fused", x.device, x=x, offset=offset, weight=weight, bias=bias)
    if offset.dtype != x.dtype or weight.dtype != x.dtype or (
        bias is not None and (bias.dtype != x.dtype or bias.shape != weight.shape[-1:])
    ):
        raise TypeError("deform_conv3d_fused: offset, weight and bias must match x's dtype and Co")
    b, d, h, w, c = x.shape
    if b * d * h * w * max(c, co, 3 * KTAPS) >= 2**31:
        raise ValueError("deform_conv3d_fused: tensor too large for the kernel's 32-bit indexing")
    fn = _lib()
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), offset.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, d, h, w, c, co, int(bool(aperture)), int(x.dtype == torch.bfloat16),
            _build.current_stream(x.device))
    deform_conv3d_fused.launches += 1
    _build.check_launch(rc, "deform_conv3d_fused")
    return out


deform_conv3d_fused.launches = 0
