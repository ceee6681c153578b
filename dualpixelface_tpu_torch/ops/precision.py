"""Mixed-precision policy (counterpart of `dualpixelface_tpu/ops/precision.py`).

bf16 compute with f32 master weights and no loss scaling: the train step
casts the parameters and the batch to bf16 at the boundary
(`torch.func.functional_call` over bf16 copies, so the gradients reach the
f32 masters through the casts), keeps the BatchNorm buffers in f32, and
casts the results back to f32 for the losses.

An f32 run is IEEE f32 throughout: `exact_f32` turns off the TF32 routes
cuDNN's convolutions take by default (and those of CUDA matmuls), as the
JAX package computes f32 convolutions in f32. The trainer and the
predictor call it when their dtype is float32.
"""
from __future__ import annotations

import torch


def resolve_policy(option) -> torch.dtype:
    """bfloat16 for precision 'bf16', 'bfloat16' or 16, else float32."""
    p = str(option.get("precision", 32)) if hasattr(option, "get") else str(option)
    return torch.bfloat16 if p in ("bf16", "bfloat16", "16") else torch.float32


def exact_f32() -> None:
    """Turn TF32 off for cuDNN's convolutions and for CUDA matmuls, so f32
    work runs at f32's 24-bit mantissa, not TF32's 10-bit one.

    The setting is process-wide: it holds for every later call in this
    process (the torch.backends flags have no per-model scope), including
    bf16 runs, whose bf16 arithmetic it does not touch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating tensors of a dict / list / tuple tree to `dtype`
    (differentiably); everything else is left as it is."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
