"""Shared model scaffold helpers (counterpart of `dualpixelface_tpu/models/base.py`).

Every reference mainmodel starts its forward with the same left/right
reference/target selection by `dataset.flip_lr` (`select_ref_target`), and
swaps left and right at test time for the group '2020-2-9_group20'
(ref src/model/stereodpnet/mainmodel.py:70-76). The group name is host-side
data, so the swap is applied by `apply_group_swap` on the host batch before
it goes to the device.
"""
from __future__ import annotations

SWAP_GROUP = "2020-2-9_group20"


def select_ref_target(batch: dict, option):
    """(reference, target) images per dataset.flip_lr."""
    if option.dataset.flip_lr:
        return batch["right"], batch["left"]
    return batch["left"], batch["right"]


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
