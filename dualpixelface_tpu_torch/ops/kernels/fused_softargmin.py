"""K3: fused x4 align-corners trilinear upsample + soft-argmin; K4: its
backward.

Replaces the TPU kernels `fused_softargmin` -> `_fsam` and `_fsam_bwd` in
`dualpixelface_tpu/ops/kernels/fused_softargmin.py`: coarse logits
[B, D, h, w] -> disparity [B, f*h, f*w], computed in f32 and returned in the
input dtype, without materialising the [B, f*D, f*h, f*w] volume, and the
gradient back onto the coarse logits, accumulated in f32 and returned in
the cost's dtype (JAX casts it by `astype`). The CUDA kernels are
`csrc/fused_softargmin.cu` and `csrc/fused_softargmin_bwd.cu` (source notes
there, and in `csrc/fsam.cuh`). Unlike the TPU kernels they take any
output height; they upsample by 4 and take any number of coarse planes, as
the TPU kernels do: up to MAX_PLANES with the D operator's taps compiled
in (one instantiation per D), above through their wide forms, which take D
at run time and the bin table from device memory. Their host operands
(`_Plan`: the y taps, each output column's weights on its quad's three
coarse columns, K4's row bands, the bin weights and values) are made once
per shape.

Each wrapper takes the plain PyTorch version for tensors on the CPU and the
kernel for CUDA tensors; anything else raises. `fused_softargmin` is
differentiable through `fused_softargmin_bwd`. Each launch counts on the
tracer's `launch.K3` or `launch.K4` counter.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dualpixelface_tpu_torch.ops.cost_volume import soft_argmin
from dualpixelface_tpu_torch.ops.kernels import _build
from dualpixelface_tpu_torch.ops.resize import _linear_matrix
from dualpixelface_tpu_torch.utils.profiling import count, to_device

FACTOR = 4  # the kernels' upsampling factor (csrc/fsam.cuh FACTOR)
MAX_PLANES = 16  # coarse D the compiled-tap kernels hold per pixel (csrc/fsam.cuh MAXD); above, the wide forms
MAX_BINS = FACTOR * MAX_PLANES
BAND_ROWS = 8  # coarse rows a K4 block owns (csrc/fused_softargmin_bwd.cu RB)


def fused_softargmin_plain(cost: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The unfused math: f32 align-corners trilinear upsample of the coarse
    logits (two taps per operator row, along W, then H, then D), softmax
    over the bins, expectation against `disp_values`."""
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


def static_d_taps(d: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' compile-time D taps (csrc/fsam.cuh `tap_lo`/`tap_hi`):
    bin j of the 4d lies at j (d-1) / (4d - 1) between planes lo = floor of
    that and hi = min(lo + 1, d - 1). int32 [4d] each."""
    j = np.arange(FACTOR * d)
    lo = (j * (d - 1)) // (FACTOR * d - 1)
    return lo.astype(np.int32), np.minimum(lo + 1, d - 1).astype(np.int32)


def d_bins(d: int, dvals: np.ndarray) -> np.ndarray:
    """The kernels' `Bins` parameter, f32 [5, MAX_BINS] (the wide forms'
    bin table, [5, 4d], for d > MAX_PLANES): per bin the weight of its lo
    plane, of its hi plane (`static_d_taps`), its value, and the two weights
    times the value. Raises if `_two_taps` puts a non-zero weight on another
    plane than the static taps."""
    idx, wt = _two_taps(FACTOR * d, d)
    lo, hi = static_d_taps(d)
    if not (np.array_equal(idx[:, 0], lo) and np.all((wt[:, 1] == 0) | (idx[:, 1] == hi))):
        raise RuntimeError(f"fused_softargmin: the D operator's taps for D={d} differ from the kernels' static taps")
    out = np.zeros((5, max(MAX_BINS, FACTOR * d)), np.float32)
    out[:, : FACTOR * d] = wt[:, 0], wt[:, 1], dvals, wt[:, 0] * dvals, wt[:, 1] * dvals
    return out


def x_quad_weights(w: int) -> np.ndarray:
    """f32 [4w, 4]: each output column X's weights on the coarse columns
    q-1, q, q+1 of its quad q = X // 4 (and a 0), from `_two_taps`. Raises
    if a tap falls outside those three columns."""
    idx, wt = _two_taps(FACTOR * w, w)
    out = np.zeros((FACTOR * w, 4), np.float32)
    for x in range(FACTOR * w):
        for t in range(2):
            if wt[x, t] == 0:
                continue
            c = idx[x, t] - (x // FACTOR - 1)
            if not 0 <= c <= 2:
                raise RuntimeError(f"fused_softargmin: output column {x} taps coarse column {idx[x, t]}, "
                                   f"outside its quad's three")
            out[x, c] += wt[x, t]
    return out


def band_rows(h: int, rb: int) -> np.ndarray:
    """int32 [ceil(h / rb), 2]: for each band of rb coarse rows, the output
    rows [first, end) that have a tap with non-zero weight in it (K4's
    blocks recompute those rows; the taps are monotone in the row, so the
    rows are contiguous)."""
    idx, wt = _two_taps(FACTOR * h, h)
    out = np.zeros((-(-h // rb), 2), np.int32)
    for i in range(len(out)):
        hit = np.flatnonzero(((wt != 0) & (idx // rb == i)).any(axis=1))
        out[i] = hit[0], hit[-1] + 1
    return out


class _Plan:
    """One shape's launch operands, made once: the y taps, the x quad
    weights and K4's bands on the device, the bin table (the `Bins`
    parameter on the host, or for d > MAX_PLANES the wide forms' table on
    the device), and the two C entry points."""

    @torch.inference_mode(False)  # cached: usable in autograd after serving
    def __init__(self, d, h, w, dvals: np.ndarray, device):
        idx, wt = _two_taps(FACTOR * h, h)
        self.bins = d_bins(d, dvals)
        wide = d > MAX_PLANES
        self.tensors = [to_device(a, device) for a in
                        (idx, wt, x_quad_weights(w), band_rows(h, BAND_ROWS)) + ((self.bins,) if wide else ())]
        self.ytap, self.ywt, self.xu, self.bands = (t.data_ptr() for t in self.tensors[:4])
        self.bins_ptr = self.tensors[4].data_ptr() if wide else self.bins.ctypes.data
        suffix = "_wide" if wide else ""
        self.fwd = _build.entry("fused_softargmin", "dpf_fused_softargmin" + suffix, _FWD_ARGS)
        self.bwd = _build.entry("fused_softargmin_bwd", "dpf_fused_softargmin_bwd" + suffix, _BWD_ARGS)


@functools.lru_cache(maxsize=16)
def _plan(d, h, w, dvals: bytes, device) -> _Plan:
    return _Plan(d, h, w, np.frombuffer(dvals, np.float32), device)


def fused_softargmin_bwd_plain(cost: torch.Tensor, g: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The gradient of `fused_softargmin_plain` w.r.t. cost for the
    cotangent g [B, f*h, f*w], by autograd through it, in the cost's dtype."""
    with torch.enable_grad():
        leaf = cost.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fused_softargmin_plain(leaf, disp_values, factor), leaf, g)
    return grad


def _bin_values(name, cost, disp_values, factor) -> np.ndarray:
    """The bin values as f32, checked against the cost's shape and device."""
    dvals = np.asarray(disp_values, np.float32)
    if cost.ndim != 4 or dvals.shape != (factor * cost.shape[1],):
        raise ValueError(f"{name}: cost {tuple(cost.shape)} must be [B, D, h, w] "
                         f"with {factor}*D bin values, got {dvals.size}")
    _build.check_device(name, cost.device)
    return dvals


def _cuda_plan(name, cost, dvals, factor, **more) -> _Plan:
    """Check a CUDA call and return its shape's `_Plan`."""
    _build.check_cuda_tensors(name, cost.device, cost=cost, **more)
    b, d, h, w = cost.shape
    if factor != FACTOR:
        raise ValueError(f"{name}: the kernels upsample by {FACTOR}, got factor {factor}")
    if b * d * h * w >= 2**31 or b * h * w * factor * factor >= 2**31:
        raise ValueError(f"{name}: tensor too large for the kernel's 32-bit indexing")
    return _plan(d, h, w, dvals.tobytes(), cost.device)


# the C entry points' arguments: (cost, out) or (cost, g, dcost), B, D, h, w,
# the device tables (ytap, ywt, xu; K4 also bands and BAND_ROWS), the host `Bins`
# (the wide forms: the device bin table), is_bf16, the stream
_FWD_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _forward(cost, dvals, factor):
    if cost.device.type == "cpu":
        return fused_softargmin_plain(cost, dvals, factor), None
    plan = _cuda_plan("fused_softargmin", cost, dvals, factor)
    b, d, h, w = cost.shape
    out = torch.empty((b, factor * h, factor * w), dtype=cost.dtype, device=cost.device)
    rc = plan.fwd(cost.data_ptr(), out.data_ptr(), b, d, h, w, plan.ytap, plan.ywt, plan.xu, plan.bins_ptr,
                  int(cost.dtype == torch.bfloat16), _build.current_stream(cost.device))
    count("launch.K3")
    _build.check_launch(rc, "fused_softargmin")
    return out, plan


def _backward(cost, g, dvals, factor, plan):
    if plan is None:
        return fused_softargmin_bwd_plain(cost, g, dvals, factor)
    b, d, h, w = cost.shape
    dcost = torch.empty_like(cost)
    rc = plan.bwd(cost.data_ptr(), g.data_ptr(), dcost.data_ptr(), b, d, h, w, plan.ytap, plan.ywt, plan.xu,
                  plan.bands, BAND_ROWS, plan.bins_ptr, int(cost.dtype == torch.bfloat16),
                  _build.current_stream(cost.device))
    count("launch.K4")
    _build.check_launch(rc, "fused_softargmin_bwd")
    return dcost


class _FusedSoftargmin(torch.autograd.Function):
    """K3 forward; the backward (K4) recomputes from the saved cost with the
    forward's plan."""

    @staticmethod
    def forward(ctx, cost, dvals, factor):
        out, plan = _forward(cost, dvals, factor)
        ctx.save_for_backward(cost)
        ctx.dvals, ctx.factor, ctx.plan = dvals, factor, plan
        return out

    @staticmethod
    def backward(ctx, g):
        (cost,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plan is not None:
            _build.check_cuda_tensors("fused_softargmin_bwd", cost.device, cost=cost, g=g)
        return _backward(cost, g, ctx.dvals, ctx.factor, ctx.plan), None, None


def fused_softargmin(cost: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """cost [B, D, h, w] -> disparity [B, factor*h, factor*w],
    differentiable in cost. CPU tensors: the plain version. CUDA tensors:
    the K3 kernel (K4 for the backward), or an error."""
    dvals = _bin_values("fused_softargmin", cost, disp_values, factor)
    return _FusedSoftargmin.apply(cost, dvals, factor)


def fused_softargmin_bwd(cost: torch.Tensor, g: torch.Tensor, disp_values, factor: int = 4) -> torch.Tensor:
    """The gradient of `fused_softargmin` w.r.t. cost [B, D, h, w] for the
    cotangent g [B, factor*h, factor*w], in the cost's dtype. CPU tensors:
    `fused_softargmin_bwd_plain`. CUDA tensors: the K4 kernel, or an error."""
    dvals = _bin_values("fused_softargmin_bwd", cost, disp_values, factor)
    b, d, h, w = cost.shape
    if g.shape != (b, factor * h, factor * w):
        raise ValueError(f"fused_softargmin_bwd: g {tuple(g.shape)} must be {(b, factor * h, factor * w)}")
    plan = None if cost.device.type == "cpu" else _cuda_plan("fused_softargmin_bwd", cost, dvals, factor, g=g)
    return _backward(cost, g, dvals, factor, plan)
