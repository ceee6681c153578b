"""Host-side helpers (counterpart of `dualpixelface_tpu/utils/`): the
metric packs' table printer, `tensor2numpy`, and the modules
`file_manager`, `profiling` and `visualizer`."""
from __future__ import annotations

import numpy as np
import torch

from dualpixelface_tpu_torch.utils.table import Table

__all__ = ["Table", "tensor2numpy"]


def tensor2numpy(tree):
    """Tensors (any device) of a dict / list / tuple tree as numpy arrays;
    bf16 and f16 tensors become float32, which numpy can hold. Anything
    else is passed through `np.asarray`."""
    if isinstance(tree, dict):
        return {k: tensor2numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensor2numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(tree)
