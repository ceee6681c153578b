"""The split-TF32 (3xTF32) arithmetic of the f32 routes of every kernel
with a contraction: K5, K2, K1, T1 and T4.

The tensor cores take f32 operands only as TF32 (10 explicit mantissa
bits). The f32 routes of `csrc/conv3d_dslice.cu` (K5),
`csrc/deform_conv3d_bwd.cu` (K2), `csrc/deform_conv3d.cu` (K1),
`csrc/conv3d_dslice_v2.cu` (T1) and `csrc/prims_dot.cu` (T4) keep f32's
accuracy by splitting each f32 operand a into two TF32 halves, both
bit-masked, never rounded:

    hi = a with its low 13 bits cleared
    lo = (a - hi) with its low 13 bits cleared   (a - hi is exact)

and summing three TF32 products in the f32 accumulator, the small ones
first: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, below f32's last bit
of the result, is left out). Each product of two TF32 values is exact in
f32, so `product_3xtf32` below predicts every product term of the card bit
for bit; only the order of the f32 sums differs.

`route` names a kernel's route for a dtype, the same for all five.
`split_tf32` is the wrappers' weight split (the weight planes K5, K2, K1
and T1 read; T4 splits both operands in the kernel). `product_3xtf32`
and `product_1xtf32` are the plain versions of the arithmetic, for the
CPU tests (`tests/test_torch_split_f32.py`): nothing on the kernels' path
calls them.
"""
from __future__ import annotations

import torch

# 0xffffe000 as an int32: clears the 13 mantissa bits TF32 does not keep
TF32_MASK = -(1 << 13)


def route(name: str, dtype: torch.dtype) -> str:
    """The route of kernel `name` for a dtype: "tensor_cores" (bf16
    `wgmma`) or "tensor_cores_3xtf32" (f32: split-TF32 `wgmma`); any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "tensor_cores_3xtf32"
    raise TypeError(f"{name}: no kernel for dtype {dtype}")


def tf32_bits(a: torch.Tensor) -> torch.Tensor:
    """a (f32) with its low 13 mantissa bits cleared: TF32 by truncation."""
    return (a.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two bit-masked TF32 halves (hi, lo) of an f32 tensor."""
    hi = tf32_bits(a)
    return hi, tf32_bits(a - hi)


def split_planes(a: torch.Tensor) -> torch.Tensor:
    """hi and lo of an f32 tensor stacked as [2, *a.shape], the layout in
    which the kernels take a split weight (hi, then lo)."""
    return torch.stack(split_tf32(a))


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the f32 routes compute it: both split into
    TF32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums."""
    a_hi, a_lo = split_tf32(a.float())
    b_hi, b_lo = split_tf32(b.float())
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def product_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (each operand's low 13 bits dropped, as the
    tensor cores read an f32 input): what the f32 routes avoid."""
    return tf32_bits(a.float()) @ tf32_bits(b.float())
