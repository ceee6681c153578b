"""T2-T4: the primitives the fused deform kernel is built from, as kernels
of their own, so that their rates on the card can be measured
(`dualpixelface_tpu_torch.tools.bench_vpu_prims`).

Replace the TPU kernels of `tools/bench_vpu_prims.py`:

  * T2 `lane_gather_sum` <- `gather_bench` (`csrc/prims_gather.cu`): a
    gather along 128-wide rows, 8 index rows summed;
  * T3 `transpose_sum` <- `transpose_bench` (`csrc/prims_transpose.cu`):
    8 slabs [128, 80] transposed to [80, 128] and summed;
  * T4 `batched_dot` <- `dot_bench` (`csrc/prims_dot.cu`): a per-g product
    [m, k] x [k, 64] with f32 sums, on the tensor cores in both dtypes
    (`dot_route`): bf16 products for bf16, split-TF32 (3xTF32) ones for
    f32, which keep IEEE f32's accuracy (`split_f32.py`).

What bounds each on the H100 and how its design meets that is in its
source note. T2 and T3 add in the data dtype, rounding after each add in
index order, as the TPU kernels' `acc` does, so kernel and plain version
agree bit for bit. Each wrapper takes the plain PyTorch version for tensors
on the CPU and the kernel for CUDA tensors; anything else raises, as does a
CUDA call at widths the kernel is not built for. Each launch counts on the
tracer's `launch.T2`, `launch.T3` or `launch.T4` counter. No gradients: the
TPU kernels have none.
"""
from __future__ import annotations

import ctypes

import torch

from dualpixelface_tpu_torch.ops.kernels import _build, split_f32
from dualpixelface_tpu_torch.utils.profiling import count

LANES = 128   # T2: table row width; T3: slab rows
REPS = 8      # T2: index rows per g; T3: slabs per g
SLAB_C = 80   # T3: slab columns
DOT_N = 64    # T4: the kernel's output width

# T2's index dtype for each data dtype (Mosaic's dynamic_gather needs equal
# bit widths; the port keeps the pairing)
INDEX_DTYPE = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def lane_gather_sum_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab [G, rows, 128], idx [G, 8, 128] -> out[g, r, l] = sum over k of
    tab[g, r, idx[g, k, l] mod 128], added in tab's dtype in k order."""
    g, rows, lanes = tab.shape
    acc = torch.zeros_like(tab)
    for k in range(idx.shape[1]):
        ix = (idx[:, k:k + 1, :].long() & (LANES - 1)).expand(g, rows, lanes)
        acc = acc + torch.gather(tab, 2, ix)
    return acc


def transpose_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """x [G, 8, 128, 80] -> out[g] = sum over k of x[g, k]^T, [G, 80, 128],
    added in x's dtype in k order."""
    acc = torch.zeros(x.shape[0], x.shape[3], x.shape[2], dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k].transpose(1, 2)
    return acc


def batched_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [G, m, k], b [G, k, n] -> a @ b in f32 (the inputs widened to f32,
    where a bf16 product is exact)."""
    return torch.bmm(a.float(), b.float())


def dot_route(dtype: torch.dtype) -> str:
    """T4's kernel route for a dtype: "tensor_cores" (bf16 `wgmma`) or
    "tensor_cores_3xtf32" (f32: split-TF32 `wgmma`)."""
    return split_f32.route("batched_dot", dtype)


def _check_rank(name, ndim, **tensors):
    for key, t in tensors.items():
        if t.ndim != ndim:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, not of rank {ndim}")


def lane_gather_sum(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """T2. tab [G, rows, 128] f32 or bf16, idx [G, 8, 128] int32 (f32 data)
    or int16 (bf16 data). Kernel and plain version alike take each index
    modulo 128, so no index reads outside its row and both agree on any
    input (the tool's indices lie in [0, 128)). CPU tensors: the plain
    version. CUDA tensors: the kernel, or an error."""
    _check_rank("lane_gather_sum", 3, tab=tab, idx=idx)
    g, rows, lanes = tab.shape
    if lanes != LANES or tuple(idx.shape) != (g, REPS, LANES):
        raise ValueError(f"lane_gather_sum: tab {tuple(tab.shape)} / idx {tuple(idx.shape)} "
                         f"must be [G, rows, {LANES}] / [G, {REPS}, {LANES}]")
    if INDEX_DTYPE.get(tab.dtype) != idx.dtype:
        raise TypeError(f"lane_gather_sum: {tab.dtype} data takes {INDEX_DTYPE.get(tab.dtype)} indices, "
                        f"not {idx.dtype}")
    _build.check_device("lane_gather_sum", tab.device)
    if tab.device.type == "cpu":
        return lane_gather_sum_plain(tab, idx)
    _build.check_cuda_tensors("lane_gather_sum", tab.device, tab=tab)
    if idx.device != tab.device or not idx.is_contiguous():
        raise ValueError("lane_gather_sum: idx must be contiguous and on tab's device")
    fn = _build.entry("prims_gather", "dpf_lane_gather_sum",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = torch.empty_like(tab)
    rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), g, rows, int(tab.dtype == torch.bfloat16),
            _build.current_stream(tab.device))
    count("launch.T2")
    _build.check_launch(rc, "lane_gather_sum")
    return out


def transpose_sum(x: torch.Tensor) -> torch.Tensor:
    """T3. x [G, 8, 128, 80] f32 or bf16 -> [G, 80, 128]. CPU tensors: the
    plain version. CUDA tensors: the kernel, or an error."""
    _check_rank("transpose_sum", 4, x=x)
    if tuple(x.shape[1:]) != (REPS, LANES, SLAB_C):
        raise ValueError(f"transpose_sum: x {tuple(x.shape)} must be [G, {REPS}, {LANES}, {SLAB_C}]")
    _build.check_device("transpose_sum", x.device)
    if x.device.type == "cpu":
        return transpose_sum_plain(x)
    _build.check_cuda_tensors("transpose_sum", x.device, x=x)
    fn = _build.entry("prims_transpose", "dpf_transpose_sum",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    out = torch.empty((x.shape[0], SLAB_C, LANES), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], int(x.dtype == torch.bfloat16),
            _build.current_stream(x.device))
    count("launch.T3")
    _build.check_launch(rc, "transpose_sum")
    return out


def batched_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T4. a [G, m, k], b [G, k, n], one dtype (f32 or bf16) -> [G, m, n]
    f32. CPU tensors: the plain version. CUDA tensors: the kernel (n = 64,
    rows of k * element size a multiple of 16 bytes: the TMA's granule;
    bf16: bf16 `wgmma`, f32: 3xTF32 `wgmma`), or an error."""
    _check_rank("batched_dot", 3, a=a, b=b)
    g, m, k = a.shape
    if b.shape[:2] != (g, k):
        raise ValueError(f"batched_dot: a {tuple(a.shape)} / b {tuple(b.shape)} must be [G, m, k] / [G, k, n]")
    _build.check_device("batched_dot", a.device)
    if a.device.type == "cpu":
        return batched_dot_plain(a, b)
    n = b.shape[2]
    if n != DOT_N:
        raise ValueError(f"batched_dot: the kernel takes n = {DOT_N} output channels, not {n}")
    if k * a.element_size() % 16:
        raise ValueError(f"batched_dot: the kernel takes rows of k * element size a multiple of 16 bytes, "
                         f"not k = {k} in {a.dtype}")
    _build.check_cuda_tensors("batched_dot", a.device, a=a, b=b)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("batched_dot: a and b must start on 16-byte boundaries")
    fn = _build.entry("prims_dot", "dpf_batched_dot",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, k, n, int(a.dtype == torch.bfloat16),
            _build.current_stream(a.device))
    count("launch.T4")
    _build.check_launch(rc, "batched_dot")
    return out
