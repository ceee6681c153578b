"""Weights from the JAX package's (params, batch_stats) trees.

`read_flax_msgpack` reads a checkpoint the JAX package saved
(`flax.serialization.to_bytes`) without Flax. `state_dict_from_jax` maps a
Flax StereoDPNet variable tree onto the reference torch `state_dict` names
the port's modules carry (the port's own
numpy copy of the mapping in `tools/export_stereodpnet_checkpoint.py`), so
a JAX-trained checkpoint loads into the port with `strict=True`. Flax conv
kernels [*k, I, O] become torch [O, I, *k]; transposed-conv kernels
[*k, O, I] become torch ConvTranspose [I, O, *k].
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn


def _f2t_conv(w):
    w = np.asarray(w)
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


class _Mapper:
    def __init__(self, params, stats):
        self.params = params
        self.stats = stats
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(root, path):
        node = root
        for p in path.split("/"):
            node = node[p]
        return node

    def conv(self, fpath, tname, bias=False):
        self.sd[f"{tname}.weight"] = _f2t_conv(self._get(self.params, f"{fpath}/kernel"))
        if bias:
            self.sd[f"{tname}.bias"] = np.asarray(self._get(self.params, f"{fpath}/bias"))

    def bn(self, fpath, tname):
        p = self._get(self.params, fpath)
        s = self._get(self.stats, fpath)
        self.sd[f"{tname}.weight"] = np.asarray(p["scale"])
        self.sd[f"{tname}.bias"] = np.asarray(p["bias"])
        self.sd[f"{tname}.running_mean"] = np.asarray(s["mean"])
        self.sd[f"{tname}.running_var"] = np.asarray(s["var"])
        self.sd[f"{tname}.num_batches_tracked"] = np.asarray(0, np.int64)

    def convbn(self, fpath, tname):
        self.conv(f"{fpath}/Conv_0", f"{tname}.0")
        self.bn(f"{fpath}/BatchNorm_0", f"{tname}.1")

    def tconvbn(self, fpath, tname):
        self.sd[f"{tname}.0.weight"] = _f2t_conv(self._get(self.params, f"{fpath}/ConvTranspose_0/kernel"))
        self.bn(f"{fpath}/BatchNorm_0", f"{tname}.1")

    def prelu(self, fpath, tname):
        self.sd[tname] = np.asarray(self._get(self.params, f"{fpath}/alpha")).reshape(1)

    def dpblock(self, fpath, tname):
        self.convbn(f"{fpath}/conv1", f"{tname}.conv1.0")
        self.prelu(f"{fpath}/PReLU_0", f"{tname}.conv1.1.weight")
        self.convbn(f"{fpath}/conv2", f"{tname}.conv2.0")
        self.prelu(f"{fpath}/PReLU_1", f"{tname}.conv2.1.weight")
        for i in range(3):
            self.convbn(f"{fpath}/conv_dilate{i}", f"{tname}.conv_dilate.{i}")
        self.convbn(f"{fpath}/conv3", f"{tname}.conv3")
        self.prelu(f"{fpath}/PReLU_2", f"{tname}.prelu.weight")
        self.convbn(f"{fpath}/conv4", f"{tname}.conv4.0")
        self.prelu(f"{fpath}/PReLU_3", f"{tname}.conv4.1.weight")
        self.conv(f"{fpath}/conv5/Conv_0", f"{tname}.conv5.depthwise")
        self.conv(f"{fpath}/conv5/Conv_1", f"{tname}.conv5.pointwise")
        self.bn(f"{fpath}/conv5/BatchNorm_0", f"{tname}.conv5.bn")
        self.prelu(f"{fpath}/conv5/PReLU_0", f"{tname}.conv5.prelu.weight")
        self.conv(f"{fpath}/conv_skip", f"{tname}.conv_skip", bias=True)

    def hourglass(self, fpath, tname):
        for cname in ("conv1", "conv3", "conv4"):
            self.convbn(f"{fpath}/{cname}", f"{tname}.{cname}.0")
        self.convbn(f"{fpath}/conv2", f"{tname}.conv2")
        for cname in ("conv5", "conv6"):
            self.tconvbn(f"{fpath}/{cname}", f"{tname}.{cname}")

    def deform_pack(self, fpath, tname):
        self.sd[f"{tname}.weight"] = _f2t_conv(self._get(self.params, f"{fpath}/weight"))
        self.sd[f"{tname}.bias"] = np.asarray(self._get(self.params, f"{fpath}/bias"))
        self.conv(f"{fpath}/conv_offset", f"{tname}.conv_offset", bias=True)


def state_dict_from_jax(params, batch_stats, block_stack: int = 1) -> dict[str, np.ndarray]:
    """Flax StereoDPNet (params, batch_stats) -> reference torch state_dict
    (numpy arrays), key for key what the JAX package's exporter emits."""
    m = _Mapper(params, batch_stats)
    fe = "feature_extraction"
    for i, idx in enumerate((0, 2, 4)):
        m.convbn(f"{fe}/firstconv{i}", f"{fe}.firstconv.{idx}")
    m.dpblock(f"{fe}/block1", f"{fe}.block1")
    for i in range(block_stack):
        m.dpblock(f"{fe}/interblock1_{i}", f"{fe}.interblock1.{i}")
    m.dpblock(f"{fe}/block2", f"{fe}.block2")
    for i in range(block_stack):
        m.dpblock(f"{fe}/interblock2_{i}", f"{fe}.interblock2.{i}")
    m.dpblock(f"{fe}/block3", f"{fe}.block3")
    for i in range(3):
        for fpart, tpart in ((f"lateral{i}", f"inner_blocks.{i}"), (f"output{i}", f"layer_blocks.{i}")):
            m.conv(f"{fe}/fpn/{fpart}", f"{fe}.fpn.{tpart}", bias=True)
    m.convbn(f"{fe}/lastconv0", f"{fe}.lastconv.0")
    m.convbn(f"{fe}/lastconv1", f"{fe}.lastconv.2")

    at, AT = "cost_volume/attention", "cost_volume.attention_layer"
    m.conv(f"{at}/Conv_0", f"{AT}.mask_convs.0")
    m.bn(f"{at}/BatchNorm_0", f"{AT}.mask_convs.1")
    m.conv(f"{at}/Conv_1", f"{AT}.mask_convs.3.0")
    p = m._get(params, f"{at}/InstanceNorm_0/GroupNorm_0")
    # the reference registers its InstanceNorm twice (attribute + Sequential)
    for tname in (f"{AT}.normalize", f"{AT}.mask_convs.3.1"):
        m.sd[f"{tname}.weight"] = np.asarray(p["scale"])
        m.sd[f"{tname}.bias"] = np.asarray(p["bias"])

    ag = "aggregation"
    m.convbn(f"{ag}/dres0_0", f"{ag}.dres0.0")
    m.convbn(f"{ag}/dres0_1", f"{ag}.dres0.2")
    m.convbn(f"{ag}/dres1_0", f"{ag}.dres1.0")
    m.convbn(f"{ag}/dres1_1", f"{ag}.dres1.2")
    for i in (2, 3, 4):
        m.hourglass(f"{ag}/dres{i}", f"{ag}.dres{i}")
    for i in (1, 2, 3):
        m.convbn(f"{ag}/classif{i}_0", f"{ag}.classif{i}.0")
        m.conv(f"{ag}/classif{i}_1", f"{ag}.classif{i}.2")

    ne = "normal_estimator"
    nep = params.get(ne, {})
    if "deform_conv1" in nep:
        for i in (1, 2):
            m.deform_pack(f"{ne}/deform_conv{i}", f"{ne}.deform_conv{i}")
            m.bn(f"{ne}/act{i}", f"{ne}.act{i}.0")
    if "orig_conv0" in nep:
        m.convbn(f"{ne}/orig_conv0", f"{ne}.original_conv.0")
        m.convbn(f"{ne}/orig_conv1", f"{ne}.original_conv.2")
    if nep:
        for i in range(6):
            m.conv(f"{ne}/n_convs{i}", f"{ne}.n_convs.{i}.0")
    return m.sd


def _msgpack_value(buf: memoryview, i: int):
    """(value, next offset) of the msgpack item at buf[i]: the subset Flax
    emits (maps, lists, strings, bytes, numbers, and arrays as extension
    type 1 holding (shape, dtype name, C-order bytes))."""
    t = buf[i]
    i += 1
    if t <= 0x7F:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if 0x80 <= t <= 0x9F or t in (0xDC, 0xDD, 0xDE, 0xDF):  # map, array
        if t <= 0x9F:
            n, pairs = t & 0x0F, t < 0x90
        else:
            w = 2 if t in (0xDC, 0xDE) else 4
            n, pairs, i = int.from_bytes(buf[i:i + w], "big"), t >= 0xDE, i + w
        items = []
        for _ in range(2 * n if pairs else n):
            v, i = _msgpack_value(buf, i)
            items.append(v)
        return (dict(zip(items[::2], items[1::2])) if pairs else items), i
    if 0xA0 <= t <= 0xBF:
        return str(buf[i:i + (t & 0x1F)], "utf-8"), i + (t & 0x1F)
    if t in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[t], i
    if t in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB):  # bytes, str
        w = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4}[t]
        n, i = int.from_bytes(buf[i:i + w], "big"), i + w
        raw = buf[i:i + n]
        return (bytes(raw) if t <= 0xC6 else str(raw, "utf-8")), i + n
    if t in (0xCA, 0xCB):
        n = 4 if t == 0xCA else 8
        return float(np.frombuffer(bytes(buf[i:i + n]), ">f4" if n == 4 else ">f8")[0]), i + n
    if 0xCC <= t <= 0xD3:  # uint, int of 1..8 bytes
        n = 1 << ((t - 0xCC) % 4)
        return int.from_bytes(buf[i:i + n], "big", signed=t >= 0xD0), i + n
    if 0xC7 <= t <= 0xC9 or 0xD4 <= t <= 0xD8:  # ext, fixext
        if t >= 0xD4:
            n = 1 << (t - 0xD4)
        else:
            w = 1 << (t - 0xC7)
            n, i = int.from_bytes(buf[i:i + w], "big"), i + w
        if buf[i] != 1:
            raise ValueError(f"msgpack extension type {buf[i]} is not an array")
        (shape, dtype, raw), _ = _msgpack_value(buf[i + 1:i + 1 + n], 0)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape), i + 1 + n
    raise ValueError(f"unknown msgpack type byte {t:#x}")


def read_flax_msgpack(path) -> dict:
    """The variable tree of a checkpoint that `flax.serialization.to_bytes`
    wrote ({"params": ..., "batch_stats": ...}), as nested dicts of numpy
    arrays: the port's own reader, for the committed checkpoint. It does
    not join the chunked form Flax uses for arrays over 2**30 bytes."""
    buf = memoryview(Path(path).read_bytes())
    tree, end = _msgpack_value(buf, 0)
    if end != len(buf):
        raise ValueError(f"{path}: {len(buf) - end} bytes after the msgpack value")
    return tree


def load_state_dict(model: nn.Module, state_dict: dict) -> nn.Module:
    """Load numpy arrays or tensors into `model` with strict=True, casting
    to each target's device and dtype."""
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v for k, v in state_dict.items()},
        strict=True,
    )
    return model
