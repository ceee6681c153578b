"""Preprocess orchestrators (a copy of `dualpixelface_tpu/data/preprocess/preprocess.py`;
ref dataloader/preprocess/preprocess.py:16-126).

basic_transform: ToNumpy -> crop (soft/hard sizing; soft rounds H*ratio and
W*ratio down to crop_factor multiples, keeping shapes in a small static set so
XLA never recompiles per-sample) -> photometric aug -> float conversion ->
PCA lighting -> normalization. Exposes the crop origin in `.coords`.

raw_transform: ToNumpy -> float conversion only (ref preprocess.py:114-126).

Randomness: every `apply` takes an explicit numpy Generator so augmentation is
reproducible per (seed, epoch, index) — replaces the reference's global-RNG
draws (preprocess.py:69-72).
"""
from __future__ import annotations

import numpy as np

from dualpixelface_tpu_torch.data.preprocess import augmentation as T
from dualpixelface_tpu_torch.utils.file_manager import error_handler


def _check_finite(arrs, what: str):
    for a in arrs:
        if a is not None:
            error_handler(
                bool(np.isfinite(a).all()), f"invalid value found in {what}", __name__, True
            )


def get_crop_size(inputs, ratio: float, factor: int) -> tuple[int, int]:
    """Soft crop sizing: floor(ceil(size*ratio) / factor) * factor
    (ref preprocess.py:29-44)."""
    size = None
    for x in inputs:
        if x is not None:
            size = (x.shape[0], x.shape[1])
            break
    if size is None:
        raise RuntimeError("all inputs are None")
    n = (np.ceil(np.array(size) * ratio) // factor).astype(int)
    error_handler(
        bool((n > 0).all()),
        f"soft crop of {size} at ratio {ratio} rounds below crop_factor {factor}",
        __name__, True,
    )
    return tuple(int(factor) * n)


class basic_transform:
    """use_native=True (default) routes RGB-uint8 inputs through the fused
    C++ data-plane (native/dphost.cpp) when libdphost.so is built — one pass
    for crop+photometric+normalize, ~35x faster per image than the numpy
    chain; the numpy chain remains the reference path and automatic fallback.
    Both consume the RNG in the same order, so runs are reproducible across
    paths."""

    def __init__(self, option, use_native: bool = True):
        self.opt = option
        self.coords = [0, 0]
        self.use_native = use_native

    def _crop_params(self, inputs, targets, rng):
        if "crop_aug" not in self.opt.augmentation:
            return None, None
        crop_opt = self.opt.crop_aug
        if crop_opt.type == "soft_crop":
            size = get_crop_size(
                inputs, crop_opt.soft_crop.crop_ratio, crop_opt.soft_crop.crop_factor
            )
        else:
            size = (crop_opt.hard_crop.crop_height, crop_opt.hard_crop.crop_width)
        cropper = T.Cropper(crop_opt, size, rng)
        return cropper, size

    def _photo_params(self, rng):
        if "photo_aug" not in self.opt.augmentation:
            return None
        p = self.opt.photo_aug
        uniform = lambda: float(rng.uniform(0.7, 1.2))
        return dict(
            brightness=uniform() if p.brightness else 0,
            gamma=uniform() if p.gamma else 0,
            contrast=uniform() if p.contrast else 0,
            light_std=float(rng.uniform(0.5, 5.0)) if p.light else 0,
        )

    def apply(self, inputs_, targets_, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else np.random.default_rng()
        inputs, targets = T.ToNumpy()(list(inputs_), list(targets_))

        cropper, _size = self._crop_params(inputs, targets, rng)

        if self.use_native and self._native_eligible(inputs, targets):
            return self._apply_native(inputs, targets, cropper, rng)

        if cropper is not None:
            inputs, targets = cropper(inputs, targets)
            self.coords = cropper.coords

        photo = self._photo_params(rng)
        if photo is not None:
            transforms = [
                T.PhotometricAug(photo["brightness"], photo["gamma"], photo["contrast"]),
                T.ToFloat(),
                T.Lighting(photo["light_std"], rng),
                T.Normalizer(),
            ]
        else:
            transforms = [T.ToFloat(), T.Normalizer()]

        inputs, targets = T.Compose(transforms)(inputs, targets)
        _check_finite(inputs, "inputs")
        _check_finite(targets, "targets")
        return inputs, targets

    @staticmethod
    def _native_eligible(inputs, targets=()) -> bool:
        from dualpixelface_tpu_torch.data.preprocess import native

        if not native.available():
            return False
        ok_inputs = all(
            x is None or (x.dtype == np.uint8 and x.ndim == 3 and x.shape[-1] == 3)
            for x in inputs
        )
        ok_targets = all(t is None or t.dtype != np.uint8 for t in targets)
        return ok_inputs and ok_targets

    def _apply_native(self, inputs, targets, cropper, rng):
        from dualpixelface_tpu_torch.data.preprocess import native

        if cropper is not None:
            i, j, tw, th = cropper._select(inputs, targets)
            self.coords = cropper.coords = [i, j]
        else:
            first = next(x for x in inputs if x is not None)
            i = j = 0
            th, tw = first.shape[0], first.shape[1]
        crop = (j, i, th, tw)

        photo = self._photo_params(rng)
        b = g = c = 0.0
        light_std = 0.0
        if photo is not None:
            b, g, c = photo["brightness"], photo["gamma"], photo["contrast"]
            light_std = photo["light_std"]

        out_inputs = []
        for x in inputs:
            if x is None:
                out_inputs.append(None)
                continue
            light_rgb = np.zeros(3, np.float32)
            if light_std:
                alpha = rng.normal(0.0, light_std, size=3).astype(np.float32)
                light_rgb = (
                    T.LIGHTING_EIGVEC * alpha[None, :] * T.LIGHTING_EIGVAL[None, :]
                ).sum(1).astype(np.float32)
            out_inputs.append(native.fused_photo_normalize(x, crop, b, g, c, light_rgb))

        oy, ox = crop[0], crop[1]
        out_targets = [
            None if t is None else np.ascontiguousarray(
                t[oy : oy + th, ox : ox + tw], np.float32
            )
            for t in targets
        ]
        _check_finite(out_inputs, "inputs")
        _check_finite(out_targets, "targets")
        return out_inputs, out_targets


class raw_transform:
    def __init__(self, option, crop: bool = False):
        self.opt = option
        self.crop = crop

    def apply(self, inputs_, targets_, rng: np.random.Generator | None = None):
        inputs, targets = T.ToNumpy()(list(inputs_), list(targets_))
        return T.ToFloat()(inputs, targets)
