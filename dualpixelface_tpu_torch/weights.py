"""Weights from the JAX package's (params, batch_stats) trees.

`read_flax_msgpack` reads a checkpoint the JAX package saved
(`flax.serialization.to_bytes`) without Flax. `state_dict_from_jax` maps a
Flax variable tree onto the port's `state_dict`: for StereoDPNet, the
reference torch names the port's modules carry (the port's own
numpy copy of the mapping in `tools/export_stereodpnet_checkpoint.py`), so
a JAX-trained checkpoint loads into the port with `strict=True` (the ASM's
PReLU of `asm_activation: "relu"`, which the exporter leaves out, is mapped
to `cost_volume.attention_layer.prelu.weight`); for the zoo's stereonet,
psmnet, nnet, dpnet and BTS's decoder (`model=`), the port's own names,
which follow the JAX tree, with Flax's automatic names (`Conv_0`,
`ResidualBlock_3`, `BasicBlock_12`, `TorchBlock_2`, ...) mapped in their
call order; for BTS's encoder, torchvision's names; for the face parser
(`face_seg`), the reference's; for `DeformConvPack2D`, torch's; for the
3-D deformable convs (`deform_conv3d`), the reference's. Flax conv
kernels [*k, I, O] become torch [O, I, *k]; transposed-conv kernels
[*k, O, I] become torch ConvTranspose [I, O, *k].
"""
from __future__ import annotations

import re
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
        self.dwsep(f"{fpath}/conv5", f"{tname}.conv5")
        self.conv(f"{fpath}/conv_skip", f"{tname}.conv_skip", bias=True)

    def dwsep(self, fpath, tname):
        """A depthwise-separable conv (`ops.blocks.DepthwiseSeparableConv`)."""
        self.conv(f"{fpath}/Conv_0", f"{tname}.depthwise")
        self.conv(f"{fpath}/Conv_1", f"{tname}.pointwise")
        self.bn(f"{fpath}/BatchNorm_0", f"{tname}.bn")
        self.prelu(f"{fpath}/PReLU_0", f"{tname}.prelu.weight")

    def torchblock(self, fpath, tname):
        """dpnet's TorchBlock: its conv or deconv, BatchNorm and PReLU where
        the tree has them."""
        p = self._get(self.params, fpath)
        if "ConvTranspose_0" in p:
            self.sd[f"{tname}.conv.weight"] = _f2t_conv(p["ConvTranspose_0"]["kernel"])
        else:
            self.conv(f"{fpath}/Conv_0", f"{tname}.conv")
        if "BatchNorm_0" in p:
            self.bn(f"{fpath}/BatchNorm_0", f"{tname}.bn")
        if "PReLU_0" in p:
            self.prelu(f"{fpath}/PReLU_0", f"{tname}.prelu.weight")

    def hourglass(self, fpath, tname):
        for cname in ("conv1", "conv3", "conv4"):
            self.convbn(f"{fpath}/{cname}", f"{tname}.{cname}.0")
        self.convbn(f"{fpath}/conv2", f"{tname}.conv2")
        for cname in ("conv5", "conv6"):
            self.tconvbn(f"{fpath}/{cname}", f"{tname}.{cname}")

    def attention(self, fpath, tname):
        """The ASM's MaskingAttention (fast and exact share the tree)."""
        self.conv(f"{fpath}/Conv_0", f"{tname}.mask_convs.0")
        self.bn(f"{fpath}/BatchNorm_0", f"{tname}.mask_convs.1")
        self.conv(f"{fpath}/Conv_1", f"{tname}.mask_convs.3.0")
        p = self._get(self.params, f"{fpath}/InstanceNorm_0/GroupNorm_0")
        # the reference registers its InstanceNorm twice (attribute + Sequential)
        for name in (f"{tname}.normalize", f"{tname}.mask_convs.3.1"):
            self.sd[f"{name}.weight"] = np.asarray(p["scale"])
            self.sd[f"{name}.bias"] = np.asarray(p["bias"])
        if "PReLU_0" in self._get(self.params, fpath):
            # asm_activation "relu": the exporter names no PReLU; the port's
            # MaskingAttention calls it `prelu`
            self.prelu(f"{fpath}/PReLU_0", f"{tname}.prelu.weight")

    def anm(self, fpath, tname):
        """The ANM: the deform convs and their BatchNorms, or the ConvBN3D
        pair of `use_deform=false` (`original_conv`), then the 2-D stack."""
        p = self._get(self.params, fpath)
        if "deform_conv1" in p:
            for i in (1, 2):
                self.deform_pack(f"{fpath}/deform_conv{i}", f"{tname}.deform_conv{i}")
                self.bn(f"{fpath}/act{i}", f"{tname}.act{i}.0")
        if "orig_conv0" in p:
            self.convbn(f"{fpath}/orig_conv0", f"{tname}.original_conv.0")
            self.convbn(f"{fpath}/orig_conv1", f"{tname}.original_conv.2")
        for i in range(6):
            self.conv(f"{fpath}/n_convs{i}", f"{tname}.n_convs.{i}.0")

    def deform_pack(self, fpath, tname):
        self.sd[f"{tname}.weight"] = _f2t_conv(self._get(self.params, f"{fpath}/weight"))
        self.sd[f"{tname}.bias"] = np.asarray(self._get(self.params, f"{fpath}/bias"))
        self.conv(f"{fpath}/conv_offset", f"{tname}.conv_offset", bias=True)


    def aggregation(self, fpath, tname):
        """PSMNetHGAggregation: the pre-filters, 3 hourglasses, 3 heads."""
        self.convbn(f"{fpath}/dres0_0", f"{tname}.dres0.0")
        self.convbn(f"{fpath}/dres0_1", f"{tname}.dres0.2")
        self.convbn(f"{fpath}/dres1_0", f"{tname}.dres1.0")
        self.convbn(f"{fpath}/dres1_1", f"{tname}.dres1.2")
        for i in (2, 3, 4):
            self.hourglass(f"{fpath}/dres{i}", f"{tname}.dres{i}")
        for i in (1, 2, 3):
            self.convbn(f"{fpath}/classif{i}_0", f"{tname}.classif{i}.0")
            self.conv(f"{fpath}/classif{i}_1", f"{tname}.classif{i}.2")

    def spp(self, fpath, tname):
        """PSMNet's SPP tower. Flax numbers its blocks in call order
        (ConvBN_0-2 the first convs, ConvBN_3-6 the pool branches, ConvBN_7
        the last; BasicBlock_<n> through layer1-4 of 3, C/2, 3, 3 blocks)."""
        p = self._get(self.params, fpath)
        c = np.shape(p["ConvBN_0"]["Conv_0"]["kernel"])[-1]
        for i in range(3):
            self.convbn(f"{fpath}/ConvBN_{i}", f"{tname}.firstconv.{i}")
        n = 0
        for layer, blocks in enumerate((3, c // 2, 3, 3), start=1):
            for j in range(blocks):
                fb, tb = f"{fpath}/BasicBlock_{n}", f"{tname}.layer{layer}.{j}"
                self.convbn(f"{fb}/ConvBN_0", f"{tb}.convbn1")
                self.convbn(f"{fb}/ConvBN_1", f"{tb}.convbn2")
                if "Conv_0" in p[f"BasicBlock_{n}"]:
                    self.conv(f"{fb}/Conv_0", f"{tb}.downsample.0")
                    self.bn(f"{fb}/BatchNorm_0", f"{tb}.downsample.1")
                n += 1
        for i in range(4):
            self.convbn(f"{fpath}/ConvBN_{3 + i}", f"{tname}.branches.{i}")
        self.convbn(f"{fpath}/ConvBN_7", f"{tname}.lastconv")
        self.conv(f"{fpath}/Conv_0", f"{tname}.classify")


def _stereonet(m: _Mapper) -> None:
    """Flax numbers the tower's convs in call order: Conv_0..Conv_{k-1}
    the stride-2 convs, Conv_k the last."""
    fe = "feature_extraction"
    k = sum(1 for name in m.params[fe] if name.startswith("Conv_")) - 1
    for i in range(k):
        m.conv(f"{fe}/Conv_{i}", f"{fe}.downsample.{i}", bias=True)
    for part in (fe, "refinement"):
        for i in range(6):
            m.convbn(f"{part}/ResidualBlock_{i}/ConvBN_0", f"{part}.blocks.{i}.convbn")
    m.conv(f"{fe}/Conv_{k}", f"{fe}.lastconv", bias=True)
    for i in range(4):
        m.convbn(f"filter{i}", f"filter{i}")
    m.conv("conv3d_alone", "conv3d_alone", bias=True)
    m.convbn("refinement/ConvBN_0", "refinement.convbn")
    m.conv("refinement/Conv_0", "refinement.lastconv", bias=True)


def _psmnet(m: _Mapper) -> None:
    m.spp("feature_extraction", "feature_extraction")
    m.aggregation("aggregation", "aggregation")


def _nnet(m: _Mapper) -> None:
    m.spp("feature_extraction", "feature_extraction")
    for name in [f"dres{i}_{j}" for i in range(5) for j in (0, 1)] + ["classify_0"]:
        m.convbn(name, name)
    m.conv("classify_1", "classify_1")
    for i in range(7):
        m.conv(f"convs{i}", f"convs.{i}")
    if "normal_module" in m.params:
        nm = "normal_module"
        for name in ("wc0_0", "wc0_1", "pool1", "pool2", "pool3"):
            m.convbn(f"{nm}/{name}", f"{nm}.{name}")
        for i in range(7):
            m.conv(f"{nm}/n_convs{i}", f"{nm}.n_convs.{i}")


def _dpnet(m: _Mapper) -> None:
    """Flax numbers an Encoder's TorchBlocks in call order: TorchBlock_0
    the conv, _1 the 1x1 after the depthwise-separable conv, _2 the skip."""
    m.torchblock("enc_layer1_1/TorchBlock_0", "enc_layer1_1.block")
    for name in (n for n in m.params if n.startswith("enc_layer") and n != "enc_layer1_1"):
        for i, part in enumerate(("block", "out", "skip")):
            m.torchblock(f"{name}/TorchBlock_{i}", f"{name}.{part}")
        m.dwsep(f"{name}/DWSep_0", f"{name}.dwsep")
        m.prelu(f"{name}/PReLU_0", f"{name}.prelu.weight")
    m.prelu("shared_prelu", "shared_prelu.weight")
    for name in ("dec_layer4", "dec_layer3", "dec_layer2", "dec_layer1", "last_layer"):
        m.torchblock(f"{name}/TorchBlock_0", f"{name}.deconv")
        for i in range(3):
            m.dwsep(f"{name}/DWSep_{i}", f"{name}.dwsep.{i}")
        m.torchblock(f"{name}_b", f"{name}_b")
    for i in range(1, 5):
        m.dwsep(f"skip_layer{i}", f"skip_layer{i}")
    for i in range(1, 6):
        m.torchblock(f"conv_last_layer{i}", f"conv_last_layer{i}")


_DENSE_LAYER = re.compile(r"denseblock(\d+)_layer(\d+)$")
_TRANSITION = re.compile(r"transition(\d+)_(norm|conv)$")
_BOTTLENECK = re.compile(r"layer(\d+)_(\d+)$")


def _bts_encoder(m: _Mapper, f: str, t: str) -> None:
    """A JAX `ResNetEncoder` tree under path `f` to torchvision's names
    under `t` (the inverse of the JAX package's
    `tools/convert_bts_encoder.py`)."""
    enc = m._get(m.params, f) if f else m.params
    f = f"{f}/" if f else ""
    if "densenet" in enc:
        for name in enc["densenet"]:
            fn, tn = f"{f}densenet/{name}", f"{t}features"
            if name == "conv0":
                m.conv(fn, f"{tn}.conv0")
            elif name in ("norm0", "norm5"):
                m.bn(fn, f"{tn}.{name}")
            elif _DENSE_LAYER.match(name):
                b, layer = _DENSE_LAYER.match(name).groups()
                for part in ("norm1", "norm2"):
                    m.bn(f"{fn}/{part}", f"{tn}.denseblock{b}.denselayer{layer}.{part}")
                for part in ("conv1", "conv2"):
                    m.conv(f"{fn}/{part}", f"{tn}.denseblock{b}.denselayer{layer}.{part}")
            else:
                b, part = _TRANSITION.match(name).groups()
                (m.bn if part == "norm" else m.conv)(fn, f"{tn}.transition{b}.{part}")
        return
    m.conv(f"{f}conv1", f"{t}conv1")
    m.bn(f"{f}bn1", f"{t}bn1")
    for name in (n for n in enc if _BOTTLENECK.match(n)):
        layer, block = _BOTTLENECK.match(name).groups()
        fn, tn = f"{f}{name}", f"{t}layer{layer}.{block}"
        for i in (1, 2, 3):
            m.conv(f"{fn}/conv{i}", f"{tn}.conv{i}")
            m.bn(f"{fn}/bn{i}", f"{tn}.bn{i}")
        if "down_conv" in enc[name]:
            m.conv(f"{fn}/down_conv", f"{tn}.downsample.0")
            m.bn(f"{fn}/down_bn", f"{tn}.downsample.1")


def bts_encoder_state_dict(params, batch_stats) -> dict[str, np.ndarray]:
    """A JAX BTS encoder's own (params, batch_stats), as
    `tools/convert_bts_encoder.py` writes them, to the port encoder's
    torchvision-named state_dict."""
    m = _Mapper(params, batch_stats)
    _bts_encoder(m, "", "")
    return m.sd


def _bts(m: _Mapper) -> None:
    """The encoder to torchvision's names (`_bts_encoder`), the decoder
    after the JAX tree: `Conv_<i>` of AtrousConv the 1x1 (`reduce`) then
    the dilated 3x3, of Reduction1x1 its convs in call order, of Upconv its
    conv."""
    _bts_encoder(m, "encoder", "encoder.")
    dec = m.params["decoder"]
    for name, node in dec.items():
        f, t = f"decoder/{name}", f"decoder.{name}"
        if name.startswith("bn"):
            m.bn(f, t)
        elif name.startswith("upconv"):
            m.conv(f"{f}/Conv_0", f"{t}.conv")
        elif name.startswith("daspp_") and name != "daspp_conv":
            m.conv(f"{f}/Conv_0", f"{t}.reduce")
            m.conv(f"{f}/Conv_1", f"{t}.dilated")
            for bn in ("first_bn", "mid_bn"):
                if bn in node:
                    m.bn(f"{f}/{bn}", f"{t}.{bn}")
        elif name.startswith("reduc"):
            for i in range(len(node)):
                m.conv(f"{f}/Conv_{i}", f"{t}.convs.{i}")
        else:
            m.conv(f, t)


def _face_seg(m: _Mapper) -> None:
    """BiSeNet to the reference's names (the inverse of the JAX package's
    `tools/convert_face_seg_weights.py`): Flax's ConvBNReLU {Conv_0,
    BatchNorm_0} is {conv, bn}; a ResNet18Block's Conv_0/1/2 and
    BatchNorm_0/1/2 are conv1, conv2, downsample.0 and bn1, bn2,
    downsample.1, its blocks ResNet18Block_{2l + b} layer{l + 1}.{b}."""

    def convbnrelu(f, t):
        m.conv(f"{f}/Conv_0", f"{t}.conv")
        m.bn(f"{f}/BatchNorm_0", f"{t}.bn")

    m.conv("resnet/Conv_0", "cp.resnet.conv1")
    m.bn("resnet/BatchNorm_0", "cp.resnet.bn1")
    for i in range(8):
        f, t = f"resnet/ResNet18Block_{i}", f"cp.resnet.layer{i // 2 + 1}.{i % 2}"
        for j, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"), ("downsample.0", "downsample.1"))):
            if f"Conv_{j}" in m.params["resnet"][f"ResNet18Block_{i}"]:
                m.conv(f"{f}/Conv_{j}", f"{t}.{conv}")
                m.bn(f"{f}/BatchNorm_{j}", f"{t}.{bn}")
    for name in ("conv_avg", "conv_head16", "conv_head32"):
        convbnrelu(name, f"cp.{name}")
    for name in ("arm16", "arm32"):
        convbnrelu(f"{name}/ConvBNReLU_0", f"cp.{name}.conv")
        m.conv(f"{name}/Conv_0", f"cp.{name}.conv_atten")
        m.bn(f"{name}/BatchNorm_0", f"cp.{name}.bn_atten")
    convbnrelu("ffm/ConvBNReLU_0", "ffm.convblk")
    m.conv("ffm/Conv_0", "ffm.conv1")
    m.conv("ffm/Conv_1", "ffm.conv2")
    for name in ("conv_out", "conv_out16", "conv_out32"):
        convbnrelu(f"{name}/ConvBNReLU_0", f"{name}.conv")
        m.conv(f"{name}/Conv_0", f"{name}.conv_out")


def _deform_conv(m: _Mapper) -> None:
    """`DeformConvPack2D`, and the 3-D `DeformConv3D`, `DeformConvPack3D`
    and `DeformConvPack3D_d`: weight [*k, Cin, Cout] to [Cout, Cin, *k], the
    bias where the module has one, and the offset head `conv_offset` where
    it has one (its kernel and bias: a Flax `nn.Conv`, or at the 3x3x3 /
    stride 1 / pad 1 geometry the same parameters of `_DSliceConv3D`)."""
    m.sd["weight"] = _f2t_conv(m.params["weight"])
    if "bias" in m.params:
        m.sd["bias"] = np.asarray(m.params["bias"])
    if "conv_offset" in m.params:
        m.conv("conv_offset", "conv_offset", bias=True)


ZOO = {"stereonet": _stereonet, "psmnet": _psmnet, "nnet": _nnet, "dpnet": _dpnet, "bts": _bts,
       "face_seg": _face_seg, "deform_conv2d": _deform_conv, "deform_conv3d": _deform_conv}


def state_dict_from_jax(params, batch_stats, block_stack: int = 1, model: str = "stereodpnet") -> dict[str, np.ndarray]:
    """Flax (params, batch_stats) of `model` -> the port's state_dict (numpy
    arrays). StereoDPNet and StereoDPNet+ (one tree): key for key what the
    JAX package's exporter emits, the reference torch names. The zoo
    models (`ZOO`): the port's names, which follow the JAX tree; "face_seg"
    (BiSeNet) the reference's names, "deform_conv2d" (`DeformConvPack2D`,
    `batch_stats` unused) torch's, "deform_conv3d" (`DeformConv3D`,
    `DeformConvPack3D`, `DeformConvPack3D_d`, `batch_stats` unused) the
    reference's: `weight`, `bias`, `conv_offset.*`."""
    m = _Mapper(params, batch_stats)
    if model in ZOO:
        ZOO[model](m)
        return m.sd
    if model not in ("stereodpnet", "stereodpnet_plus"):
        raise NotImplementedError(f"no weight mapping for model {model!r}")
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

    m.attention("cost_volume/attention", "cost_volume.attention_layer")

    m.aggregation("aggregation", "aggregation")

    if params.get("normal_estimator"):
        m.anm("normal_estimator", "normal_estimator")
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
