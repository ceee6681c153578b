"""StereoDPNet (counterpart of `dualpixelface_tpu/models/stereodpnet/mainmodel.py`).

DPBlock-FPN features at 1/4 resolution (both views in one tower call) ->
ASM sub-pixel cost volume over `level` planes -> PSMNet 3-hourglass
aggregation -> x4 trilinear upsample + soft-argmin over 4*level bins
(fused in kernel K3 when `fused_regression`) -> ANM normal branch.

Inputs: batch["left"], batch["right"] [B, H, W, 3], batch["K"] [B, 3, 3],
batch["abvalue"] [B, 2]. Outputs (the JAX package's contract), with n = 1
head in eval mode and n = 3 in train mode (`.train()`; the aggregation's
three classifier heads, the ANM on the first): pred_depth [B, n, H, W];
prob_depth [B, n, 4*level, H, W] or None under the fused regression;
pred_normal [B, 1, H, W, 3]; ref_feature [B, H/4, W/4]; with
`model.return_offsets` set, also anm_offset1 and anm_offset2 [B, D, h, w, 81]
(the ANM deform convs' offsets, after the clamp when `deform_offset_clamp`).
Each stage runs inside a tracer span (`utils/profiling`):
`model.feature_extraction`, `model.cost_volume`, `model.aggregation`,
`model.regression` (the heads' soft-argmin) and `model.normal_estimator`.
`graph_stages` names the stages a serving `Predictor` replays from CUDA
graphs on the card (`utils/graphs`); the outputs are computed eagerly from
theirs, so none holds a graph's buffer.
"""
from __future__ import annotations

import torch
from torch import nn

from dualpixelface_tpu_torch.models import register_model
from dualpixelface_tpu_torch.models.base import select_ref_target
from dualpixelface_tpu_torch.models.stereodpnet.modules import ASMCostVolume, FeatureExtraction
from dualpixelface_tpu_torch.models.stereodpnet.normal_module import ANM
from dualpixelface_tpu_torch.ops.aggregation import PSMNetHGAggregation
from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities, soft_argmin
from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import fused_softargmin
from dualpixelface_tpu_torch.utils.profiling import span


@register_model("stereodpnet")
class STEREODPNET(nn.Module):
    def __init__(self, option):
        super().__init__()
        self.option = option
        opt = option.model
        self.fused = bool(opt.get("fused_regression", False))
        self.disparities = regression_disparities(opt.mindisp, opt.maxdisp, opt.level, 4)
        self.feature_extraction = FeatureExtraction(option)
        self.cost_volume = ASMCostVolume(option, opt.mindisp, opt.maxdisp)
        self.aggregation = PSMNetHGAggregation(opt.inplanes, upsample=not self.fused)
        self.normal_estimator = ANM(option, opt.mindisp, opt.maxdisp) if opt.predict_normal else None

    @property
    def graph_stages(self) -> tuple:
        """The front stages, which copy nothing from the host per call. The
        regression and the ANM stay eager: they hold the hand-written
        kernels' launches (K3, K1, K5). Under `compat_nearest` the ASM
        copies its sampling index per call, so it stays eager too."""
        if self.cost_volume.modes["compat_nearest"]:
            return ("feature_extraction", "aggregation")
        return ("feature_extraction", "cost_volume", "aggregation")

    def forward(self, batch: dict) -> dict:
        ref_img, tar_img = select_ref_target(batch, self.option)
        b = ref_img.shape[0]
        both = torch.movedim(torch.cat([ref_img, tar_img], dim=0), -1, 1)  # [2B, 3, H, W]
        with span("model.feature_extraction"):
            both_fea = self.feature_extraction(both)  # [2B, C, H/4, W/4]
        ref_fea, tar_fea = both_fea[:b], both_fea[b:]
        with span("model.cost_volume"):
            cost = self.cost_volume(ref_fea, tar_fea)  # [B, 2C, D, H/4, W/4]
        with span("model.aggregation"):
            cost_logits, cost_feats = self.aggregation(cost)

        disps, probs = [], []
        with span("model.regression"):
            for logits in cost_logits:
                if self.fused:
                    disps.append(fused_softargmin(logits, self.disparities, factor=4))
                else:
                    disp, prob = soft_argmin(logits, self.disparities)
                    disps.append(disp)
                    probs.append(prob)

        normal = off1 = off2 = None
        if self.normal_estimator is not None:
            with span("model.normal_estimator"):
                normal, off1, off2 = self.normal_estimator(cost_feats[0], disps[0], batch)
        results = {
            "pred_depth": torch.stack(disps, dim=1),
            "prob_depth": torch.stack(probs, dim=1) if probs else None,
            "pred_normal": None if normal is None else normal[:, None],
            "ref_feature": torch.amax(ref_fea, dim=1),
        }
        if self.option.model.get("return_offsets", False):
            results["anm_offset1"] = off1
            results["anm_offset2"] = off2
        return results
