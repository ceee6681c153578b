"""K5: dense 3x3x3 pad-1 stride-1 convolution, NDHWC (the ANM deform
offset heads).

Replaces the TPU kernel `conv3d_dslice_pallas` -> `_conv3d_call` in
`dualpixelface_tpu/ops/kernels/conv3d_dslice.py`. The CUDA kernel
(`csrc/conv3d_dslice.cu`) is an implicit GEMM over the flattened (tap,
channel) axis with f32 accumulation on the tensor cores (`wgmma`): bf16
products for bf16, split-TF32 (3xTF32) ones for f32, which keep IEEE f32's
accuracy (`split_f32.py`; the TPU kernel ran only in bf16 for lack of
VMEM); what bounds it and how its design meets that is in the source note
there. The wrapper first lays the operands out for the tensor cores (the
job the JAX wrapper does with `w2`): `pack_conv3d` for bf16 (x's channels
padded to a multiple of 8, the weight as [N_PAD, Kp] with K contiguous),
`pack_conv3d_3xtf32` for f32 (channels to a multiple of 4, the weight's two
TF32 planes [2, N_PAD, Kp]).

`conv3d_dslice` takes the plain PyTorch version for tensors on the CPU and
the kernel for CUDA tensors, either dtype; anything else raises, as does a
CUDA call with other than CO output channels (the one width the kernel is
built for). `conv3d_dslice.launches` counts kernel launches.

The gradient is not a kernel, as in the JAX package, whose custom VJP
differentiates the XLA reference (`conv3d_dslice.py:217-227`): it is the
library's 3-D convolution backward (`conv3d_dslice_bwd`) on both devices.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dualpixelface_tpu_torch.ops.kernels import _build, split_f32

CO = 81  # the kernel's output channels: the deform offset heads' 3 x 27, its only caller
N_PAD = 88  # CO padded to eleven n8 tiles: the tensor-core kernel's N
BK = 64  # the bf16 route's reduction tile (128 bytes); the packed weight's K is a multiple of it
BK_F32 = 32  # the f32 route's (128 bytes of f32)


def pack_conv3d(x: torch.Tensor, weight: torch.Tensor, n_pad: int, step: int = 8,
                bk: int = BK) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's operands: x [B, D, H, W, C] with zero
    channels appended up to Cp, a multiple of `step` (itself when C is one),
    and weight [3, 3, 3, C, Co] as B [n_pad, Kp], K contiguous: row n,
    column tap * Cp + c holds weight[kd, kh, kw, c, n], zero for padded
    channels, for n >= Co and for columns past 27 Cp (Kp = 27 Cp rounded up
    to `bk`)."""
    c, co = x.shape[-1], weight.shape[-1]
    cp = -(-c // step) * step
    if cp != c:
        x = F.pad(x, (0, cp - c))
        weight = F.pad(weight, (0, 0, 0, cp - c))
    k = 27 * cp
    kp = -(-k // bk) * bk
    wt = weight.reshape(k, co)
    if (kp, n_pad) != (k, co):
        wt = F.pad(wt, (0, n_pad - co, 0, kp - k))
    return x, wt.t().contiguous()


def pack_conv3d_3xtf32(x: torch.Tensor, weight: torch.Tensor, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 route's operands: x padded to a multiple of 4 channels and
    the packed weight [n_pad, Kp] (Kp a multiple of BK_F32) split into its
    two TF32 planes [2, n_pad, Kp] (hi, lo; `split_f32.split_planes`)."""
    x, wt = pack_conv3d(x, weight, n_pad, 4, BK_F32)  # a 16-byte granule of x: 4 f32 channels
    return x, split_f32.split_planes(wt)


def route(dtype: torch.dtype) -> str:
    """K5's kernel route for a dtype: "tensor_cores" (bf16 `wgmma`) or
    "tensor_cores_3xtf32" (f32: split-TF32 `wgmma`)."""
    return split_f32.route("conv3d_dslice", dtype)


def conv3d_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [B, D, H, W, C], weight [3, 3, 3, C, Co] -> the 3x3x3 pad-1 conv's
    f32 accumulator [B, D, H, W, Co]: im2col over the 27 taps, one f32
    product (the inputs widened to f32)."""
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = torch.cat(
        [xp[:, kd:kd + d, kh:kh + h, kw:kw + w] for kd in range(3) for kh in range(3) for kw in range(3)],
        dim=-1,
    )
    return (cols.reshape(-1, 27 * c).float() @ weight.reshape(27 * c, co).float()).reshape(b, d, h, w, co)


def conv3d_dslice_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, D, H, W, C], weight [3, 3, 3, C, Co] -> [B, D, H, W, Co]: the
    f32 accumulator (`conv3d_f32`) rounded to x's dtype; the bias is then
    added in that dtype."""
    out = conv3d_f32(x, weight).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def conv3d_dslice_bwd(x, weight, bias, g):
    """(gx, gw, gb) of the 3x3x3 pad-1 conv for the cotangent g
    [B, D, H, W, Co]: the library's conv3d input and weight gradients in the
    channels-first layout, f32 accumulation, each in its input's dtype (gb
    None without a bias)."""
    x_cf = x.permute(0, 4, 1, 2, 3)
    g_cf = g.permute(0, 4, 1, 2, 3)
    w_cf = weight.permute(4, 3, 0, 1, 2)
    gx = torch.nn.grad.conv3d_input(x_cf.shape, w_cf, g_cf, padding=1)
    gw = torch.nn.grad.conv3d_weight(x_cf, w_cf.shape, g_cf, padding=1)
    gb = None if bias is None else g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(bias.dtype)
    return gx.permute(0, 2, 3, 4, 1).contiguous(), gw.permute(2, 3, 4, 1, 0).contiguous(), gb


class _Conv3dDslice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        return conv3d_dslice_bwd(*ctx.saved_tensors, g)


def conv3d_dslice(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """3x3x3 pad-1 conv, NDHWC, differentiable. CPU tensors: the plain
    version. CUDA tensors: the K5 kernel (bf16: bf16 `wgmma`; f32: 3xTF32
    `wgmma`), or an error."""
    if x.ndim != 5 or weight.shape[:4] != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"conv3d_dslice: x {tuple(x.shape)} / weight {tuple(weight.shape)} "
                         "must be [B, D, H, W, C] / [3, 3, 3, C, Co]")
    _build.check_device("conv3d_dslice", x.device)
    return _Conv3dDslice.apply(x, weight, bias)


conv3d_dslice.launches = 0


def _forward(x, weight, bias):
    if x.device.type == "cpu":
        return conv3d_dslice_plain(x, weight, bias)
    co = weight.shape[-1]
    if co != CO:
        raise ValueError(f"conv3d_dslice: the kernel takes Co = {CO} output channels, not {co}")
    if bias is not None and bias.shape != weight.shape[-1:]:
        raise ValueError(f"conv3d_dslice: bias {tuple(bias.shape)} must be [{co}]")
    _build.check_cuda_tensors("conv3d_dslice", x.device, x=x, weight=weight, bias=bias)
    b, d, h, w, c = x.shape
    if b * d * h * w * max(c, co) >= 2**31:
        raise ValueError("conv3d_dslice: tensor too large for the kernel's 32-bit indexing")
    fn = _build.entry("conv3d_dslice", "dpf_conv3d_k3",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    bf16 = x.dtype == torch.bfloat16
    x, weight = pack_conv3d(x, weight, N_PAD) if bf16 else pack_conv3d_3xtf32(x, weight, N_PAD)
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, d, h, w, x.shape[-1], co, int(bf16), _build.current_stream(x.device))
    conv3d_dslice.launches += 1
    _build.check_launch(rc, "conv3d_dslice")
    return out
