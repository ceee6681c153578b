"""STEREODPNET_PLUS: the serving configuration of StereoDPNet (counterpart
of `dualpixelface_tpu/models/stereodpnet_plus/mainmodel.py`). The same
module tree and parameters; `config.json` selects the windowed deform
semantics with the offset clamp, the fused soft-argmin and the hoisted
attention head."""
from __future__ import annotations

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.stereodpnet.mainmodel import STEREODPNET


@register_model("stereodpnet_plus")
class STEREODPNET_PLUS(STEREODPNET):
    """Same module tree as STEREODPNET; only the config defaults differ."""
