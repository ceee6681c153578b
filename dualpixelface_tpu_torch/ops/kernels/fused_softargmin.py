"""K3: fused x4 align-corners trilinear upsample + soft-argmin; K4: its
backward.

Replaces the TPU kernels `fused_softargmin` -> `_fsam` and `_fsam_bwd` in
`dualpixelface_tpu/ops/kernels/fused_softargmin.py`: coarse logits
[B, D, h, w] -> disparity [B, f*h, f*w], computed in f32 and returned in the
input dtype, without materialising the [B, f*D, f*h, f*w] volume, and the
gradient back onto the coarse logits, accumulated in f32 and returned in
the cost's dtype (JAX casts it by `astype`). The CUDA kernels are
`csrc/fused_softargmin.cu` and `csrc/fused_softargmin_bwd.cu` (source notes
there). Unlike the TPU kernels they take any output height.

Each wrapper takes the plain PyTorch version for tensors on the CPU and the
kernel for CUDA tensors; anything else raises. `fused_softargmin` is
differentiable through `fused_softargmin_bwd`. `fused_softargmin.launches`
and `fused_softargmin_bwd.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dualpixelface_tpu_torch.ops.cost_volume import soft_argmin
from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.resize import _linear_matrix

MAX_PLANES = 16  # coarse D the kernel holds per pixel (csrc MAXD)


def fused_softargmin_plain(cost: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The unfused math: f32 align-corners trilinear upsample of the coarse
    logits (two taps per operator row, along W, then H, then D, as the
    kernel does), softmax over the bins, expectation against `disp_values`."""
    up = cost.float()
    for axis in (3, 2, 1):
        n = up.shape[axis]
        idx, wt = (torch.as_tensor(a, device=cost.device) for a in _two_taps(n * factor, n))
        shape = [1] * up.ndim
        shape[axis] = n * factor
        up = (up.index_select(axis, idx[:, 0]) * wt[:, 0].reshape(shape)
              + up.index_select(axis, idx[:, 1]) * wt[:, 1].reshape(shape))
    disp, _ = soft_argmin(up, disp_values)
    return disp.to(cost.dtype)


def _two_taps(out_size: int, in_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Each row of the [out, in] operator as its (at most two) non-zero
    (index, weight) pairs: int32 [out, 2], float32 [out, 2]."""
    m = _linear_matrix(out_size, in_size, True)
    idx = np.zeros((out_size, 2), np.int32)
    wt = np.zeros((out_size, 2), np.float32)
    for r in range(out_size):
        nz = np.flatnonzero(m[r])
        if len(nz) > 2:
            raise ValueError("linear operator row with more than two taps")
        idx[r, : len(nz)] = nz
        wt[r, : len(nz)] = m[r, nz]
    return idx, wt


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _device_tables(d, h, w, factor, dvals, device):
    """The operator taps and bin values for one shape, on the device."""
    out = []
    for n_in in (d, h, w):
        idx, wt = _two_taps(n_in * factor, n_in)
        out += [torch.as_tensor(idx, device=device), torch.as_tensor(wt, device=device)]
    out.append(torch.as_tensor(np.asarray(dvals, np.float32), device=device))
    return tuple(out)


def fused_softargmin_bwd_plain(cost: torch.Tensor, g: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The gradient of `fused_softargmin_plain` w.r.t. cost for the
    cotangent g [B, f*h, f*w], by autograd through it, in the cost's dtype."""
    with torch.enable_grad():
        leaf = cost.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fused_softargmin_plain(leaf, disp_values, factor), leaf, g)
    return grad


def _check_inputs(name, cost, dvals, factor):
    if cost.ndim != 4 or len(dvals) != factor * cost.shape[1]:
        raise ValueError(f"{name}: cost {tuple(cost.shape)} must be [B, D, h, w] "
                         f"with {factor}*D bin values, got {len(dvals)}")
    _build.check_device(name, cost.device)


def _check_cuda_call(name, cost, factor, **more):
    _build.check_cuda_tensors(name, cost.device, cost=cost, **more)
    b, d, h, w = cost.shape
    if d > MAX_PLANES:
        raise ValueError(f"{name}: the kernel takes at most {MAX_PLANES} coarse planes, got {d}")
    if b * d * h * w >= 2**31 or b * h * w * factor * factor >= 2**31:
        raise ValueError(f"{name}: tensor too large for the kernel's 32-bit indexing")


# the C entry points' argument types: (cost, out) or (cost, g, dcost32, dcost),
# 7 sizes, the 7 tap and bin tables, is_bf16, the stream
_TABLE_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]


def _forward(cost, dvals, factor):
    if cost.device.type == "cpu":
        return fused_softargmin_plain(cost, dvals, factor)
    _check_cuda_call("fused_softargmin", cost, factor)
    b, d, h, w = cost.shape
    tables = _device_tables(d, h, w, factor, dvals, cost.device)
    fn = _build.entry("fused_softargmin", "dpf_fused_softargmin", [ctypes.c_void_p] * 2 + _TABLE_ARGS)
    out = torch.empty((b, factor * h, factor * w), dtype=cost.dtype, device=cost.device)
    rc = fn(cost.data_ptr(), out.data_ptr(), b, d, h, w, factor * d, factor * h, factor * w,
            *(t.data_ptr() for t in tables), int(cost.dtype == torch.bfloat16),
            _build.current_stream(cost.device))
    fused_softargmin.launches += 1
    _build.check_launch(rc, "fused_softargmin")
    return out


class _FusedSoftargmin(torch.autograd.Function):
    """K3 forward; the backward recomputes from the saved cost."""

    @staticmethod
    def forward(ctx, cost, dvals, factor):
        ctx.save_for_backward(cost)
        ctx.dvals, ctx.factor = dvals, factor
        return _forward(cost, dvals, factor)

    @staticmethod
    def backward(ctx, g):
        (cost,) = ctx.saved_tensors
        return fused_softargmin_bwd(cost, g.contiguous(), ctx.dvals, ctx.factor), None, None


def fused_softargmin(cost: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """cost [B, D, h, w] -> disparity [B, factor*h, factor*w],
    differentiable in cost. CPU tensors: the plain version. CUDA tensors:
    the K3 kernel (K4 for the backward), or an error."""
    dvals = tuple(float(v) for v in np.asarray(disp_values, np.float32))
    _check_inputs("fused_softargmin", cost, dvals, factor)
    return _FusedSoftargmin.apply(cost, dvals, factor)


fused_softargmin.launches = 0


def fused_softargmin_bwd(cost: torch.Tensor, g: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The gradient of `fused_softargmin` w.r.t. cost [B, D, h, w] for the
    cotangent g [B, factor*h, factor*w], in the cost's dtype. CPU tensors:
    `fused_softargmin_bwd_plain`. CUDA tensors: the K4 kernel, or an error."""
    dvals = tuple(float(v) for v in np.asarray(disp_values, np.float32))
    _check_inputs("fused_softargmin_bwd", cost, dvals, factor)
    b, d, h, w = cost.shape
    if g.shape != (b, factor * h, factor * w):
        raise ValueError(f"fused_softargmin_bwd: g {tuple(g.shape)} must be {(b, factor * h, factor * w)}")
    if cost.device.type == "cpu":
        return fused_softargmin_bwd_plain(cost, g, dvals, factor)
    _check_cuda_call("fused_softargmin_bwd", cost, factor, g=g)
    tables = _device_tables(d, h, w, factor, dvals, cost.device)
    fn = _build.entry("fused_softargmin_bwd", "dpf_fused_softargmin_bwd", [ctypes.c_void_p] * 4 + _TABLE_ARGS)
    dcost32 = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    dcost = dcost32 if cost.dtype == torch.float32 else torch.empty_like(cost)
    rc = fn(cost.data_ptr(), g.data_ptr(), dcost32.data_ptr(), dcost.data_ptr(), b, d, h, w,
            factor * d, factor * h, factor * w, *(t.data_ptr() for t in tables),
            int(cost.dtype == torch.bfloat16), _build.current_stream(cost.device))
    fused_softargmin_bwd.launches += 1
    _build.check_launch(rc, "fused_softargmin_bwd")
    return dcost


fused_softargmin_bwd.launches = 0
