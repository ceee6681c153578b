"""K3: fused x4 align-corners trilinear upsample + soft-argmin.

Replaces the TPU kernel `fused_softargmin` -> `_fsam` in
`dualpixelface_tpu/ops/kernels/fused_softargmin.py`: coarse logits
[B, D, h, w] -> disparity [B, f*h, f*w], computed in f32 and returned in the
input dtype, without materialising the [B, f*D, f*h, f*w] volume. The CUDA
kernel is `csrc/fused_softargmin.cu` (source note there). Unlike the TPU
kernel it takes any output height.

`fused_softargmin` takes the plain PyTorch version for tensors on the CPU
and the kernel for CUDA tensors; anything else raises.
`fused_softargmin.launches` counts kernel launches.
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
def _device_tables(d, h, w, factor, dvals, device):
    """The operator taps and bin values for one shape, on the device."""
    out = []
    for n_in in (d, h, w):
        idx, wt = _two_taps(n_in * factor, n_in)
        out += [torch.as_tensor(idx, device=device), torch.as_tensor(wt, device=device)]
    out.append(torch.as_tensor(np.asarray(dvals, np.float32), device=device))
    return tuple(out)


def _lib():
    lib = _build.load("fused_softargmin")
    fn = lib.dpf_fused_softargmin
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_softargmin(cost: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """cost [B, D, h, w] -> disparity [B, factor*h, factor*w]. CPU tensors:
    the plain version. CUDA tensors: the K3 kernel, or an error."""
    dvals = tuple(float(v) for v in np.asarray(disp_values, np.float32))
    if cost.ndim != 4 or len(dvals) != factor * cost.shape[1]:
        raise ValueError(f"fused_softargmin: cost {tuple(cost.shape)} must be [B, D, h, w] "
                         f"with {factor}*D bin values, got {len(dvals)}")
    if cost.device.type == "cpu":
        return fused_softargmin_plain(cost, dvals, factor)
    if cost.device.type != "cuda":
        raise ValueError(f"fused_softargmin: no kernel for device {cost.device}")
    _build.check_cuda_tensors("fused_softargmin", cost.device, cost=cost)
    b, d, h, w = cost.shape
    if d > MAX_PLANES:
        raise ValueError(f"fused_softargmin: the kernel takes at most {MAX_PLANES} coarse planes, got {d}")
    if b * d * h * w >= 2**31 or b * h * w * factor * factor >= 2**31:
        raise ValueError("fused_softargmin: tensor too large for the kernel's 32-bit indexing")
    tables = _device_tables(d, h, w, factor, dvals, cost.device)
    fn = _lib()
    out = torch.empty((b, factor * h, factor * w), dtype=cost.dtype, device=cost.device)
    rc = fn(cost.data_ptr(), out.data_ptr(), b, d, h, w, factor * d, factor * h, factor * w,
            *(t.data_ptr() for t in tables), int(cost.dtype == torch.bfloat16),
            _build.current_stream(cost.device))
    fused_softargmin.launches += 1
    _build.check_launch(rc, "fused_softargmin")
    return out


fused_softargmin.launches = 0
