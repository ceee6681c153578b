"""Shared model scaffold helper (counterpart of `dualpixelface_tpu/models/base.py`).

Every reference mainmodel swaps left and right at test time for the group
'2020-2-9_group20' (ref src/model/stereodpnet/mainmodel.py:70-76). The group
name is host-side data, so the swap is applied by `apply_group_swap` on the
host batch before it goes to the device. The flip_lr selection is
`models/stereodpnet/mainmodel.select_ref_target`.
"""
from __future__ import annotations

SWAP_GROUP = "2020-2-9_group20"


def apply_group_swap(batch: dict, training: bool) -> dict:
    """Host-side: swap left/right for the revised test group
    (ref mainmodel.py:70-76). No-op during training or without groupname."""
    if training or "groupname" not in batch:
        return batch
    names = batch["groupname"]
    if isinstance(names, (list, tuple)) and len(names) > 0 and names[0] == SWAP_GROUP:
        batch = dict(batch)
        batch["left"], batch["right"] = batch["right"], batch["left"]
    return batch
