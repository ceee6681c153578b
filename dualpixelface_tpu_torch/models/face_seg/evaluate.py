"""FaceMaskEstimator, the demo-mask tool (counterpart of
`dualpixelface_tpu/models/face_seg/evaluate.py`).

Runs the BiSeNet face parser on the image resized to size x size
(align-corners bilinear) after ImageNet normalisation, takes the argmax
class per pixel, resizes the label map back to the image's size bilinearly
as floats and rounds it (the JAX package's order, kept), and returns the
face mask: classes 1..13 of CelebAMask-HQ's 19.

Weights: a torch state_dict file with the reference's names (its
`79999_iter.pth` loads as it is) where the JAX package restores an Orbax
tree; without one the network keeps its init from seed 0 (for wiring
tests).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dualpixelface_tpu_torch import resolve_device
from dualpixelface_tpu_torch.data.preprocess.augmentation import IMAGENET_MEAN, IMAGENET_STD
from dualpixelface_tpu_torch.models.face_seg.model import BiSeNet, init_bisenet
from dualpixelface_tpu_torch.ops.precision import exact_f32
from dualpixelface_tpu_torch.ops.resize import resize_linear

FACE_CLASS_RANGE = (1, 13)  # inclusive: skin..lips of the CelebAMask-HQ labels


class FaceMaskEstimator:
    def __init__(self, checkpoint: str | None = None, n_classes: int = 19, size: int = 512, device="cuda",
                 dtype=torch.float32):
        """`checkpoint`: a torch state_dict file (a dict of tensors, or one
        under "state_dict"), loaded with strict=True. A float32 estimator
        turns TF32 off for the process (`ops.precision.exact_f32`)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.size = size
        if dtype == torch.float32:
            exact_f32()
        model = init_bisenet(BiSeNet(n_classes))
        if checkpoint is not None:
            sd = torch.load(Path(checkpoint), map_location="cpu", weights_only=True)
            model.load_state_dict(sd.get("state_dict", sd), strict=True)
        self.model = model.to(device=self.device, dtype=dtype).eval()

    def logits(self, image: np.ndarray) -> torch.Tensor:
        """The main head's logits [1, n_classes, size, size] of `image`."""
        x = np.asarray(image, np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        x = torch.from_numpy((x - IMAGENET_MEAN) / IMAGENET_STD).to(self.device)
        x = resize_linear(x[None], (self.size, self.size), (1, 2), True)
        with torch.inference_mode():
            return self.model(x.permute(0, 3, 1, 2).to(self.dtype))[0]

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: [H, W, 3] uint8 or [0, 1] float -> boolean mask [H, W]."""
        h, w = image.shape[:2]
        labels = torch.argmax(self.logits(image), dim=1).to(torch.float32)  # [1, size, size]
        labels = resize_linear(labels, (h, w), (1, 2), True)[0].round().cpu().numpy()
        lo, hi = FACE_CLASS_RANGE
        return (labels >= lo) & (labels <= hi)
