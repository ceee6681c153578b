"""Augmentation ops, pure numpy, channels-last (a copy of
`dualpixelface_tpu/data/preprocess/augmentation.py`).

Parity target: reference `dataloader/preprocess/augmentation.py:18-301`
(Compose/ToNumpy/ToTensor/Cropper/PhotometricAug/Lighting/Normalizer built on
torchvision functional). Differences by design:

  * channels-last throughout ([H, W, C] floats) — the TPU-native layout; the
    reference's ToTensor CHW permute never happens.
  * randomness comes from an explicit `numpy.random.Generator` argument
    instead of global `random`/`np.random` state, so the pipeline is
    deterministically seedable per sample (SURVEY.md §7.3 randomness
    plumbing).
  * photometric ops implement torchvision's uint8 math directly in numpy.

`inputs` is the [left, right, center] image list, `targets` the
[depth, mask, disp, idepth, normal, albedo] list; entries may be None
(channel toggles), which every op passes through.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# AlexNet PCA lighting basis (ref augmentation.py:235-238)
LIGHTING_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
LIGHTING_EIGVEC = np.array(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    np.float32,
)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, inputs, targets):
        for t in self.transforms:
            inputs, targets = t(inputs, targets)
        return inputs, targets


class ToNumpy:
    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, inputs, targets):
        for idx, x in enumerate(inputs):
            if x is not None:
                x = np.asarray(x)
                if self.dtype is not None:
                    x = x.astype(self.dtype)
                inputs[idx] = x
        targets = [np.asarray(t) if t is not None else None for t in targets]
        return inputs, targets


class ToFloat:
    """uint8 [0,255] -> float32 [0,1]; float arrays pass through unscaled —
    exactly torchvision to_tensor's dtype-dependent scaling (ref
    augmentation.py:65-86), minus the CHW permute."""

    def _convert(self, x):
        if x is None:
            return None
        x = np.asarray(x)
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32)

    def __call__(self, inputs, targets):
        return [self._convert(x) for x in inputs], [self._convert(t) for t in targets]


class Cropper:
    """center / random / mask-aware random crop (ref augmentation.py:90-204).

    mask_random_crop retries up to max_trial times for a crop containing at
    least min_inlier mask ratio, then falls back to uniform random.
    """

    def __init__(self, option, cropped_size, rng: np.random.Generator | None = None):
        self.min_inlier = option.min_inlier
        self.max_trial = option.max_trial
        self.method = option.method
        self.cropped_size = cropped_size
        self.rng = rng if rng is not None else np.random.default_rng()
        self.coords = [0, 0]

    def _first_image(self, inputs):
        for x in inputs:
            if x is not None:
                return x
        raise RuntimeError("all inputs are None")

    def _randint(self, lo, hi):
        return int(self.rng.integers(lo, hi + 1))  # inclusive like random.randint

    def _select(self, inputs, targets):
        img = self._first_image(inputs)
        h, w = img.shape[0], img.shape[1]
        th, tw = self.cropped_size
        if self.method == "center_crop":
            j = int(round((h - th) / 2.0))
            i = int(round((w - tw) / 2.0))
        elif self.method == "random_crop":
            j = self._randint(0, h - th)
            i = self._randint(0, w - tw)
        elif self.method == "mask_random_crop":
            mask = targets[1]
            if mask is None:
                j = self._randint(0, h - th)
                i = self._randint(0, w - tw)
            else:
                coords = np.argwhere(mask > 0)
                roiy = int(coords[:, 0].min())
                roix = int(coords[:, 1].min())
                cnt = 0
                while True:
                    j = self._randint(roiy, h - th)
                    i = self._randint(roix, w - tw)
                    ratio = np.sum(mask[j : j + th, i : i + tw] > 0) / (th * tw)
                    if ratio >= self.min_inlier:
                        break
                    cnt += 1
                    if cnt >= self.max_trial:
                        j = self._randint(0, h - th)
                        i = self._randint(0, w - tw)
                        break
        else:
            raise NotImplementedError(f"invalid cropping method {self.method!r}")
        return i, j, tw, th

    def __call__(self, inputs, targets):
        i, j, tw, th = self._select(inputs, targets)
        crop = lambda x: x[j : j + th, i : i + tw] if x is not None else None
        self.coords = [i, j]
        return [crop(x) for x in inputs], [crop(t) for t in targets]


def _gray(img: np.ndarray) -> np.ndarray:
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


class PhotometricAug:
    """brightness/gamma/contrast on uint8 images (ref augmentation.py:207-227;
    torchvision functional math in numpy). A factor of 0 disables the op."""

    def __init__(self, brightness=0.0, gamma=0.0, contrast=0.0):
        self.brightness = brightness
        self.gamma = gamma
        self.contrast = contrast

    def _apply(self, img):
        x = img.astype(np.float32)
        if self.brightness != 0:
            x = np.clip(x * self.brightness, 0, 255)
        if self.gamma != 0:
            x = np.clip(255.0 * np.power(np.clip(x / 255.0, 0, 1), self.gamma), 0, 255)
        if self.contrast != 0:
            mean = round(_gray(x).mean())
            x = np.clip((1.0 - self.contrast) * mean + self.contrast * x, 0, 255)
        return x.astype(np.uint8)

    def __call__(self, inputs, targets):
        return [self._apply(x) if x is not None else None for x in inputs], targets


class Lighting:
    """AlexNet PCA lighting noise on [0,1] float RGB (ref augmentation.py:230-254)."""

    def __init__(self, alphastd, rng: np.random.Generator | None = None):
        self.alphastd = alphastd
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, inputs, targets):
        if self.alphastd == 0:
            return inputs, targets
        out = []
        for img in inputs:
            if img is not None and img.ndim == 3:
                alpha = self.rng.normal(0.0, self.alphastd, size=3).astype(np.float32)
                rgb = (LIGHTING_EIGVEC * alpha[None, :] * LIGHTING_EIGVAL[None, :]).sum(1)
                img = img + rgb[None, None, :]
            out.append(img)
        return out, targets


class Normalizer:
    """ImageNet mean/std for RGB, (0.5, 0.5) for single-channel
    (ref augmentation.py:258-301). Images only; targets untouched."""

    def _apply(self, x):
        if x is None:
            return None
        x = x.astype(np.float32)
        if x.ndim == 2:
            return (x - 0.5) / 0.5
        return (x - IMAGENET_MEAN) / IMAGENET_STD

    def __call__(self, inputs, targets):
        return [self._apply(x) for x in inputs], targets
