"""T1: dense 3x3x3 pad-1 stride-1 convolution, NDHWC, with a per-channel
affine epilogue and an optional ReLU (an eval ConvBN3D + ReLU in one pass).

Replaces the TPU kernel `conv3d_dslice_v2` -> `_conv3d_call_v2` /
`_kernel_v2` in `tools/attic/conv3d_dslice_v2.py`, which no model path
calls: it is measured against the library's conv + BatchNorm + ReLU chain
by `dualpixelface_tpu_torch.tools.bench_dslice_fold`. The CUDA kernel
(`csrc/conv3d_dslice_v2.cu`) is K5's implicit GEMM at the hourglass widths
(Co 32 and 64) with the epilogue in registers, on the tensor cores in both
dtypes (`route`): bf16 products for bf16 (operands laid out by K5's
`pack_conv3d`), split-TF32 (3xTF32) ones for f32, which keep IEEE f32's
accuracy (`pack_conv3d_3xtf32`, `split_f32.py`); what bounds it and how
its design meets that is in the source note there.

The forward computes what `_kernel_v2` computes: the f32 accumulator,
then `acc * a + b` in f32 (ab = [a; b], [2, Co] f32), then the ReLU, then
one rounding to x's dtype. The JAX package's XLA twin (`_v2_twin`) rounds
the conv to x's dtype before the affine and again after it; in bf16 the
two differ by up to one output ulp.

The gradient is the twin's VJP, as JAX's `_bwd_v2` takes it (there is no
backward kernel): the pre-activation recomputed with the twin's roundings
(the library's conv3d in x's dtype, the affine in f32, rounded), the ReLU's
gradient 1 above 0, 0 below and 0.5 at exactly 0 (`jnp.maximum`'s), the
affine's gradients in f32, and gx, gw from the library's conv3d backward
(`conv3d_dslice_bwd`).

`conv3d_dslice_v2` takes the plain PyTorch version for tensors on the CPU
and the kernel for CUDA tensors; anything else raises, as does a CUDA call
with other than 32 or 64 output channels. `conv3d_dslice_v2.launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dualpixelface_tpu_torch.ops.kernels import _build, split_f32
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import (
    conv3d_dslice_bwd, conv3d_f32, pack_conv3d, pack_conv3d_3xtf32)

COS = (32, 64)  # the kernel's output widths: the hourglass's stride-1 sites


def route(dtype: torch.dtype) -> str:
    """T1's kernel route for a dtype: "tensor_cores" (bf16 `wgmma`) or
    "tensor_cores_3xtf32" (f32: split-TF32 `wgmma`)."""
    return split_f32.route("conv3d_dslice_v2", dtype)


def conv3d_dslice_v2_plain(x: torch.Tensor, wmat: torch.Tensor, ab: torch.Tensor | None = None,
                           relu: bool = False) -> torch.Tensor:
    """x [B, D, H, W, C], wmat [3, 3, 3, C, Co], ab [2, Co] f32 or None ->
    [B, D, H, W, Co] in x's dtype: the f32 accumulator, the affine and the
    ReLU in f32, one rounding."""
    acc = conv3d_f32(x, wmat)
    if ab is not None:
        acc = acc * ab[0].float() + ab[1].float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(x.dtype)


def _relu_grad(pre: torch.Tensor) -> torch.Tensor:
    """d max(pre, 0) / d pre as `jax.grad(jnp.maximum)` gives it: 1 above 0,
    0 below, 0.5 at exactly 0."""
    return (pre > 0).float() + 0.5 * (pre == 0).float()


def conv3d_dslice_v2_bwd(x, wmat, ab, relu: bool, g):
    """(gx, gw, gab) of the twin `relu?(round(round(conv(x, w)) * a + b))`
    for the cotangent g [B, D, H, W, Co]; gab is None without ab."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wmat.permute(4, 3, 0, 1, 2), padding=1).permute(0, 2, 3, 4, 1)
    yf = y.float()
    gf = g.float()
    if ab is not None:
        a, b = ab[0].float(), ab[1].float()
        pre = (yf * a + b).to(x.dtype)
    else:
        pre = y
    if relu:
        gf = gf * _relu_grad(pre)
    gab = None
    if ab is not None:
        dims = (0, 1, 2, 3)
        gab = torch.stack([(gf * yf).sum(dim=dims), gf.sum(dim=dims)]).to(ab.dtype)
        gf = gf * a
    gx, gw, _ = conv3d_dslice_bwd(x, wmat, None, gf.to(x.dtype))
    return gx, gw, gab


class _Conv3dDsliceV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wmat, ab, relu):
        ctx.save_for_backward(x, wmat, ab)
        ctx.relu = relu
        return _forward(x, wmat, ab, relu)

    @staticmethod
    def backward(ctx, g):
        return (*conv3d_dslice_v2_bwd(*ctx.saved_tensors, ctx.relu, g), None)


def conv3d_dslice_v2(x: torch.Tensor, wmat: torch.Tensor, ab: torch.Tensor | None = None,
                     relu: bool = False) -> torch.Tensor:
    """3x3x3 pad-1 conv with the affine + ReLU epilogue, NDHWC,
    differentiable in x, wmat and ab. CPU tensors: the plain version. CUDA
    tensors: the T1 kernel (bf16: bf16 `wgmma`; f32: 3xTF32 `wgmma`), or an
    error."""
    if x.ndim != 5 or wmat.shape[:4] != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"conv3d_dslice_v2: x {tuple(x.shape)} / wmat {tuple(wmat.shape)} "
                         "must be [B, D, H, W, C] / [3, 3, 3, C, Co]")
    if ab is not None and tuple(ab.shape) != (2, wmat.shape[-1]):
        raise ValueError(f"conv3d_dslice_v2: ab {tuple(ab.shape)} must be [2, {wmat.shape[-1]}]")
    _build.check_device("conv3d_dslice_v2", x.device)
    return _Conv3dDsliceV2.apply(x, wmat, ab, bool(relu))


conv3d_dslice_v2.launches = 0


def _forward(x, wmat, ab, relu):
    if x.device.type == "cpu":
        return conv3d_dslice_v2_plain(x, wmat, ab, relu)
    co = wmat.shape[-1]
    if co not in COS:
        raise ValueError(f"conv3d_dslice_v2: the kernel takes {COS} output channels, not {co}")
    _build.check_cuda_tensors("conv3d_dslice_v2", x.device, x=x, wmat=wmat)
    if ab is not None and (ab.dtype != torch.float32 or ab.device != x.device or not ab.is_contiguous()):
        raise ValueError("conv3d_dslice_v2: ab must be contiguous float32 on x's device")
    b, d, h, w, c = x.shape
    if b * d * h * w * max(c, co) >= 2**31:
        raise ValueError("conv3d_dslice_v2: tensor too large for the kernel's 32-bit indexing")
    fn = _build.entry("conv3d_dslice_v2", "dpf_conv3d_k3_affine",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    bf16 = x.dtype == torch.bfloat16
    x, wmat = pack_conv3d(x, wmat, co) if bf16 else pack_conv3d_3xtf32(x, wmat, co)
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), wmat.data_ptr(), None if ab is None else ab.data_ptr(), out.data_ptr(),
            b, d, h, w, x.shape[-1], co, int(relu), int(bf16), _build.current_stream(x.device))
    conv3d_dslice_v2.launches += 1
    _build.check_launch(rc, "conv3d_dslice_v2")
    return out
