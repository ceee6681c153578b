"""ctypes bindings for the native host data-plane (native/dphost.cpp; a copy
of `dualpixelface_tpu/data/preprocess/native.py`).

`fused_photo_normalize` runs the crop -> brightness/gamma/contrast ->
uint8 round-trip -> /255 -> PCA-lighting -> mean/std normalization chain in
one C++ pass (OpenMP across rows). Falls back transparently when the shared
library hasn't been built (`make -C native`); equivalence with the numpy
pipeline is covered by tests/test_native_host.py, and the port's
samples against the JAX package's by tests/test_torch_data.py. This is host
code, not a kernel of the card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = Path(__file__).resolve().parents[3] / "native" / "libdphost.so"
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.crop_photo_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.crop_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def fused_photo_normalize(
    img_u8: np.ndarray,
    crop: tuple[int, int, int, int],  # (oy, ox, ch, cw)
    brightness: float = 0.0,
    gamma: float = 0.0,
    contrast: float = 0.0,
    light_rgb=None,
    mean=None,
    std=None,
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("libdphost.so not built (make -C native)")
    if not (img_u8.dtype == np.uint8 and img_u8.ndim == 3 and img_u8.shape[-1] == 3):
        raise ValueError(f"fused_photo_normalize takes [H, W, 3] uint8, got {img_u8.dtype} {img_u8.shape}")
    img_u8 = np.ascontiguousarray(img_u8)
    oy, ox, ch, cw = crop
    H, W = img_u8.shape[:2]
    if not (0 <= oy and oy + ch <= H and 0 <= ox and ox + cw <= W):
        raise ValueError(f"crop {crop} outside the image [{H}, {W}]")

    from dualpixelface_tpu_torch.data.preprocess.augmentation import IMAGENET_MEAN, IMAGENET_STD

    light = np.zeros(3, np.float32) if light_rgb is None else np.asarray(light_rgb, np.float32)
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    stdinv = (1.0 / std).astype(np.float32)
    mean = np.ascontiguousarray(mean, np.float32)

    out = np.empty((ch, cw, 3), np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.crop_photo_normalize(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        fp(out), ch, cw, oy, ox,
        ctypes.c_float(brightness), ctypes.c_float(gamma), ctypes.c_float(contrast),
        fp(np.ascontiguousarray(light)), fp(mean), fp(np.ascontiguousarray(stdinv)),
    )
    return out


def fused_crop_f32(arr: np.ndarray, crop: tuple[int, int, int, int]) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("libdphost.so not built (make -C native)")
    oy, ox, ch, cw = crop
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim == 2:
        src = arr[..., None]
    else:
        src = arr
    H, W, C = src.shape
    out = np.empty((ch, cw, C), np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.crop_f32(fp(src), H, W, C, fp(out), ch, cw, oy, ox)
    return out[..., 0] if arr.ndim == 2 else out
