"""Export a StereoDPNet checkpoint of this package to the reference's
format (counterpart of `tools/export_stereodpnet_checkpoint.py`), so that
a model trained here can be evaluated inside the reference harness.

    python -m dualpixelface_tpu_torch.tools.export_stereodpnet_checkpoint checkpoint_00.pt out.ckpt

The inverse of `convert_stereodpnet_checkpoint`: the port's state_dict
already carries the reference's names, so the exporter writes the keys the
JAX exporter writes, in its order (`reference_keys`): the ASM's
InstanceNorm under both of its names, the ANM's deform convs or its
`original_conv` pair as the checkpoint holds them, no reference-only
buffer (`costrange`, `grid`) and no ASM PReLU of `asm_activation: "relu"`
(the reference has no name for it; the JAX exporter leaves it out too).
The BatchNorms' `num_batches_tracked` are the port's counters (the JAX
package keeps none and writes 0).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from dualpixelface_tpu_torch.tools.convert_stereodpnet_checkpoint import ASM_PRELU, reference_keys


def export_stereodpnet_state_dict(state_dict: dict, block_stack: int = 1) -> dict[str, np.ndarray]:
    """The port's StereoDPNet state_dict -> the reference STEREODPNET
    state_dict (numpy), key for key and value for value what the JAX
    exporter writes for the same weights. Raises on a key of the port that
    the reference has no name for (other than the ASM PReLU)."""
    out = {}
    for key in reference_keys(state_dict.__contains__, block_stack):
        value = state_dict[key]
        out[key] = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
    extra = sorted(k for k in state_dict if k not in out and k != ASM_PRELU)
    if extra:
        raise ValueError(f"{len(extra)} keys have no name in the reference's StereoDPNet: {extra[:20]}")
    return out


def block_stack_of(state_dict: dict) -> int:
    """The tower's `block_stack`: the number of DPBlocks in `interblock1`."""
    return len({k.split(".")[2] for k in state_dict if k.startswith("feature_extraction.interblock1.")})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="a StereoDPNet checkpoint of this package -> the reference's format")
    ap.add_argument("ckpt", help="a checkpoint of this package (.pt, train/checkpoint.save_checkpoint's)")
    ap.add_argument("out_ckpt", help="output .ckpt path (torch.save of {'state_dict': ...})")
    args = ap.parse_args(argv)

    from dualpixelface_tpu_torch.train.checkpoint import load_checkpoint

    model = load_checkpoint(args.ckpt)["model"]
    sd = export_stereodpnet_state_dict(model, block_stack_of(model))
    # np.array keeps the counters' 0-d shape (np.ascontiguousarray makes them [1])
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, args.out_ckpt)
    print(f"exported {len(sd)} tensors of {args.ckpt} to {args.out_ckpt}", flush=True)


if __name__ == "__main__":
    main()
