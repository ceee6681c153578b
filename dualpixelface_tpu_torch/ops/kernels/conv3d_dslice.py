"""K5: dense 3x3x3 pad-1 stride-1 convolution, NDHWC (the ANM deform
offset heads).

Replaces the TPU kernel `conv3d_dslice_pallas` -> `_conv3d_call` in
`dualpixelface_tpu/ops/kernels/conv3d_dslice.py`. The CUDA kernel
(`csrc/conv3d_dslice.cu`) is an implicit GEMM over the flattened (tap,
channel) axis with f32 accumulation; what bounds it and how its design
meets that is in the source note there. It serves f32 and bf16 alike (the
TPU kernel ran only in bf16 for lack of VMEM).

`conv3d_dslice` takes the plain PyTorch version for tensors on the CPU and
the kernel for CUDA tensors; anything else raises, as does a CUDA call
with other than CO output channels (the one width the kernel is built for).
`conv3d_dslice.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dualpixelface_tpu_torch.ops.kernels import _build

CO = 81  # the kernel's output channels: the deform offset heads' 3 x 27, its only caller


def conv3d_dslice_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, D, H, W, C], weight [3, 3, 3, C, Co] -> [B, D, H, W, Co].
    im2col over the 27 taps, one f32 product, rounded to x's dtype; the bias
    is then added in that dtype."""
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = torch.cat(
        [xp[:, kd:kd + d, kh:kh + h, kw:kw + w] for kd in range(3) for kh in range(3) for kw in range(3)],
        dim=-1,
    )
    out = (cols.reshape(-1, 27 * c).float() @ weight.reshape(27 * c, co).float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.reshape(b, d, h, w, co)


def _lib():
    lib = _build.load("conv3d_dslice")
    fn = lib.dpf_conv3d_k3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3d_dslice(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """3x3x3 pad-1 conv, NDHWC. CPU tensors: the plain version. CUDA
    tensors: the K5 kernel, or an error."""
    if x.ndim != 5 or weight.shape[:4] != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"conv3d_dslice: x {tuple(x.shape)} / weight {tuple(weight.shape)} "
                         "must be [B, D, H, W, C] / [3, 3, 3, C, Co]")
    if x.device.type == "cpu":
        return conv3d_dslice_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_dslice: no kernel for device {x.device}")
    co = weight.shape[-1]
    if co != CO:
        raise ValueError(f"conv3d_dslice: the kernel takes Co = {CO} output channels, not {co}")
    _build.check_cuda_tensors("conv3d_dslice", x.device, x=x, weight=weight, bias=bias)
    if weight.dtype != x.dtype or (bias is not None and (bias.dtype != x.dtype or bias.shape != weight.shape[-1:])):
        raise TypeError("conv3d_dslice: weight and bias must match x's dtype and Co")
    b, d, h, w, c = x.shape
    if b * d * h * w * max(c, co) >= 2**31:
        raise ValueError("conv3d_dslice: tensor too large for the kernel's 32-bit indexing")
    fn = _lib()
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, d, h, w, c, co, int(x.dtype == torch.bfloat16), _build.current_stream(x.device))
    conv3d_dslice.launches += 1
    _build.check_launch(rc, "conv3d_dslice")
    return out


conv3d_dslice.launches = 0
