"""Plain PyTorch reference of NNet, normal-assisted stereo (Kusupati et
al., CVPR 2020) in its dual-pixel adaptation: the forward and the seeded
init, written from the model's equations for the benchmark's correctness
check. It imports nothing of the program under test.

The network, as the reference implementation's `src/model/nnet`
describes it: PSMNet's SPP feature tower on each view (three convs at half
resolution, 3 + C/2 + 3 + 3 ResNet basic blocks to a quarter, the last
three dilated, four average-pooled branches, `lastconv` and a 1x1
`classify`); the integer-shift concat volume over `level` planes; a flat
stack of 3-D residual filters (dres0-dres4) and a classifier to one logit
a plane; a 2-D context refinement of each plane's logits on [reference
features | logits] (dilated convs, leaky ReLU 0.1), added to them; for
both logit volumes a x4 trilinear resize (align_corners False) and a
soft-argmin over 4 level bins; and the normal module: the world-coordinate
volume K^-1 [u, v, 1] depth(plane), min-max scaled per sample, beside the
aggregated cost, two 3-D ConvBNs and three that pool the plane axis down to
one plane, a dilated 2-D stack summed over the planes left, a x4 bilinear
resize (align_corners True) and an L2 normalisation.

Departures from the reference implementation, each also the program's:
* every plane's shift is `int(d)` rows, truncated toward zero, and only the
  rows the shift fills are kept, as the reference writes its volume;
* the SPP branches are resized back with align_corners True;
* the soft-argmin's probabilities are returned for both heads (the
  reference returns them to its loss alone);
* eval only: BatchNorm with its running statistics, no loss.
The seeded init is StereoDPNet's recipe with each residual block's last
norm scaled (`RESIDUAL_SCALE` says why); the gaps `correct` reads are
defined in `gaps`.

Every step runs in float32 on the channels-first layout with library calls
(F.conv*, F.interpolate, F.avg_pool2d, F.batch_norm), so it needs no
kernel. Its products go through `stereodpnet.Products`: exact float32, or
for the correctness control their operands rounded to TF32 or fp8. The
state_dict names are the program's, so one state_dict loads into this
module and into the program alike.

What the benchmark asks of a reference module: `build`, `init_state_dict`,
`answer` and `gaps` (a serving mix); see the end of this file.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import stereodpnet as sdp
from benchmark.reference.stereodpnet import SPREAD_FLOOR, LeakyReLU, Products, conv_bn, run, shift_rows


def conv_bn3d(cin, cout, k=(3, 3, 3), s=1, pad=1):
    return nn.Sequential(nn.Conv3d(cin, cout, k, s, pad, bias=False), nn.BatchNorm3d(cout))


class BasicBlock(nn.Module):
    """out = convbn2(relu(convbn1(x))) + skip, the skip a strided 1x1 conv
    and BatchNorm where the block changes the shape; no activation after
    the sum."""

    def __init__(self, cin, c, stride=1, dil=1, down=False):
        super().__init__()
        self.convbn1 = conv_bn(cin, c, 3, stride, dil=dil)
        self.convbn2 = conv_bn(c, c, 3, 1, dil=dil)
        self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride, bias=False), nn.BatchNorm2d(c)) if down else None

    def forward(self, x, P):
        out = run(P, self.convbn2, torch.relu(run(P, self.convbn1, x)))
        return out + (x if self.downsample is None else run(P, self.downsample, x))


def _layer(cin, c, blocks, stride, dil, down):
    return nn.ModuleList([BasicBlock(cin, c, stride, dil, down)] + [BasicBlock(c, c, 1, dil) for _ in range(1, blocks)])


class SPPFeatureExtraction(nn.Module):
    """[N, 3, H, W] -> [N, C, H/4, W/4]. The pools' windows are 2C, C, C/2
    and C/4 (floor windows), so the quarter-resolution features must be at
    least 2C on each axis."""

    def __init__(self, c: int, cin: int = 3):
        super().__init__()
        self.firstconv = nn.ModuleList([conv_bn(cin, c, 3, 2), conv_bn(c, c), conv_bn(c, c)])
        self.layer1 = _layer(c, c, 3, 1, 1, False)
        self.layer2 = _layer(c, 2 * c, c // 2, 2, 1, True)
        self.layer3 = _layer(2 * c, 4 * c, 3, 1, 1, True)
        self.layer4 = _layer(4 * c, 4 * c, 3, 1, 2, False)
        self.pools = (2 * c, c, c // 2, c // 4)
        self.branches = nn.ModuleList([conv_bn(4 * c, c, 1) for _ in self.pools])
        self.lastconv = conv_bn(10 * c, 4 * c)
        self.classify = nn.Conv2d(4 * c, c, 1, bias=False)

    def forward(self, x, P):
        for m in self.firstconv:
            x = torch.relu(run(P, m, x))
        for block in (*self.layer1, *self.layer2):
            x = block(x, P)
        raw = x
        for block in (*self.layer3, *self.layer4):
            x = block(x, P)
        h, w = x.shape[2:]
        branches = [F.interpolate(torch.relu(run(P, m, F.avg_pool2d(x, k, k))), size=(h, w), mode="bilinear",
                                  align_corners=True) for k, m in zip(self.pools, self.branches)]
        feat = torch.cat([raw, x] + branches[::-1], 1)
        return P.conv(self.classify, torch.relu(run(P, self.lastconv, feat)))


def concat_volume(ref, tar, planes):
    """[B, 2C, D, H, W]: plane i = [ref, tar shifted by int(d_i) rows], both
    zero on the rows the shift leaves empty."""
    h = ref.shape[2]
    out = []
    for d in planes:
        k = int(d)
        rows = torch.ones(h, 1, dtype=ref.dtype, device=ref.device)
        if k > 0:
            rows[h - k:] = 0
        elif k < 0:
            rows[:-k] = 0
        out.append(torch.cat([ref * rows, shift_rows(tar, k, 2) * rows], 1))
    return torch.stack(out, 2)


class ContextStack(nn.ModuleList):
    """Dilated 3x3 convs without bias, each followed by a leaky ReLU of
    slope 0.1 (the last included). `plan`: (channels, dilation) a layer."""

    def __init__(self, cin, plan):
        chans = [cin] + [ch for ch, _ in plan]
        super().__init__([nn.Conv2d(chans[i], ch, 3, padding=dl, dilation=dl, bias=False)
                          for i, (ch, dl) in enumerate(plan)])

    def forward(self, x, P):
        act = LeakyReLU(0.1)
        for m in self:
            x = act(P.conv(m, x))
        return x


def world_volume(K, planes, ab, h, w):
    """[B, 3, D, h, w]: the quarter-resolution pixels' rays K_q^-1 [u, v,
    1] (K_q: K's first two rows over 4) times each plane's depth a / (d -
    b) (0 where not finite), min-max scaled over each sample."""
    b = K.shape[0]
    kq = torch.cat([K[:, :2] / 4.0, K[:, 2:]], 1)
    yy, xx = torch.meshgrid(torch.arange(h, device=K.device, dtype=K.dtype),
                            torch.arange(w, device=K.device, dtype=K.dtype), indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, -1)
    rays = (torch.linalg.inv(kq) @ pix).reshape(b, 3, 1, h, w)
    depth = ab[:, 1].reshape(b, 1) / (planes.reshape(1, -1) - ab[:, 0].reshape(b, 1))
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    vol = rays * depth.reshape(b, 1, -1, 1, 1)
    vmin = vol.reshape(b, -1).amin(1).reshape(b, 1, 1, 1, 1)
    vmax = vol.reshape(b, -1).amax(1).reshape(b, 1, 1, 1, 1)
    return (vol - vmin) / (vmax - vmin + 1e-6)


class NormalModule(nn.Module):
    def __init__(self, c, planes):
        super().__init__()
        self.planes = planes
        self.wc0_0 = conv_bn3d(3 + 2 * c, c)
        self.wc0_1 = conv_bn3d(c, c)
        for i in (1, 2, 3):  # stride 2 down the plane axis: D 8 -> 4 -> 2 -> 1
            setattr(self, f"pool{i}", conv_bn3d(c, c, (2, 3, 3), (2, 1, 1), (0, 1, 1)))
        self.n_convs = ContextStack(c, [(3 * c, 1), (3 * c, 2), (3 * c, 4), (2 * c, 8), (2 * c, 16), (c, 1), (3, 1)])

    def forward(self, cost, K, ab, P):
        """cost [B, 2C, D, h, w] -> unit normals [B, H, W, 3]."""
        b, _, _, h, w = cost.shape
        planes = torch.as_tensor(self.planes, dtype=torch.float32, device=cost.device)
        y = torch.cat([world_volume(K, planes, ab, h, w), cost], 1)
        for name in ("wc0_0", "wc0_1", "pool1", "pool2", "pool3"):
            y = torch.relu(run(P, getattr(self, name), y))
        nmap = sum(self.n_convs(y[:, :, i], P) for i in range(y.shape[2]))
        nmap = F.interpolate(nmap, size=(4 * h, 4 * w), mode="bilinear", align_corners=True)
        nmap = nmap / torch.linalg.vector_norm(nmap, dim=1, keepdim=True).clamp_min(1e-12)
        return torch.movedim(nmap, 1, -1)


class NNet(nn.Module):
    """The whole network, eval. forward(batch) -> pred_depth [B, 2, H, W]
    (the classifier's disparity, then the refined one), prob_depth [B, 2,
    4 level, H, W], pred_normal [B, 1, H, W, 3] (None without
    `predict_normal`), ref_feature [B, H/4, W/4] (the reference features'
    largest channel), disp_spread [B, 2, H, W] (each head's probabilities'
    standard deviation about its disparity)."""

    def __init__(self, model: dict, products: Products | None = None):
        super().__init__()
        self.products = products or Products()
        c, level = int(model["inplanes"]), int(model["level"])
        lo, hi = model["mindisp"], model["maxdisp"]
        self.planes = [float(v) for v in np.arange(level) * ((hi / 4.0 - lo / 4.0) / level) + lo / 4.0]
        n_bins = 4 * level
        self.bins = np.arange(n_bins) * ((hi - lo) / n_bins) + lo
        self.feature_extraction = SPPFeatureExtraction(c, int(model.get("input_channel", 3)))
        self.dres0_0, self.dres0_1 = conv_bn3d(2 * c, c), conv_bn3d(c, c)
        for i in (1, 2, 3, 4):
            setattr(self, f"dres{i}_0", conv_bn3d(c, c))
            setattr(self, f"dres{i}_1", conv_bn3d(c, c))
        self.classify_0 = conv_bn3d(c, c)
        self.classify_1 = nn.Conv3d(c, 1, 3, 1, 1, bias=False)
        self.convs = ContextStack(c + 1, [(4 * c, 1), (4 * c, 2), (4 * c, 4), (3 * c, 8), (2 * c, 16), (c, 1), (1, 1)])
        self.normal_module = NormalModule(c, self.planes) if model.get("predict_normal", False) else None

    def regress(self, logits):
        """Plane logits [B, D, h, w] -> (disparity [B, 4h, 4w], the
        probabilities [B, 4D, 4h, 4w], their spread about the disparity):
        x4 trilinear (align_corners False), softmax, expectation."""
        size = tuple(4 * n for n in logits.shape[1:])
        up = F.interpolate(logits[:, None], size=size, mode="trilinear", align_corners=False)[:, 0]
        prob = torch.softmax(up, 1)
        bins = torch.as_tensor(self.bins, dtype=prob.dtype, device=prob.device).reshape(1, -1, 1, 1)
        disp = (prob * bins).sum(1)
        spread = (prob * (bins - disp[:, None]).square()).sum(1).clamp_min(0).sqrt()
        return disp, prob, spread

    def forward(self, batch):
        P = self.products
        ref_fea = self.feature_extraction(torch.movedim(batch["left"], -1, 1), P)
        tar_fea = self.feature_extraction(torch.movedim(batch["right"], -1, 1), P)
        cost = concat_volume(ref_fea, tar_fea, self.planes)
        cost0 = torch.relu(run(P, self.dres0_1, torch.relu(run(P, self.dres0_0, cost))))
        cost_in0 = cost0
        for i in (1, 2, 3, 4):
            cost0 = run(P, getattr(self, f"dres{i}_1"), torch.relu(run(P, getattr(self, f"dres{i}_0"), cost0))) + cost0
        costs = P.conv(self.classify_1, torch.relu(run(P, self.classify_0, cost0)))[:, 0]  # [B, D, h, w]
        # each plane's logits refined on [reference features | logits]
        costss = torch.stack([self.convs(torch.cat([ref_fea, costs[:, i:i + 1]], 1), P)[:, 0]
                              for i in range(costs.shape[1])], 1) + costs
        disps, probs, spreads = zip(*(self.regress(t) for t in (costs, costss)))
        normal = None
        if self.normal_module is not None:
            normal = self.normal_module(torch.cat([cost_in0, cost0], 1), batch["K"], batch["abvalue"], P)[:, None]
        return {"pred_depth": torch.stack(disps, 1), "prob_depth": torch.stack(probs, 1), "pred_normal": normal,
                "ref_feature": ref_fea.amax(1), "disp_spread": torch.stack(spreads, 1)}


# The scale of each residual block's last norm (the tower's basic blocks'
# `convbn2`, the 3-D stack's `dres1_1`-`dres4_1`): a quarter. At the
# recipe's 1 every one of the tower's 25 blocks doubles its activations'
# variance (features ~1e6 at the published widths), every soft-argmin
# saturates, and on the card bf16's rounding alone moved the disparity,
# the normals and the probabilities as far as fp8's does (PERF.md).
RESIDUAL_SCALE = 0.25


def init_state_dict(model: nn.Module, seed: int, device) -> dict:
    """Seeded weights for `model`'s state_dict, StereoDPNet's recipe
    (`stereodpnet.init_state_dict`: every convolution N(0, 2 / n), n its
    kernel volume times its output channels; norms at identity, running
    statistics 0 and 1), each residual block's last norm scaled by
    RESIDUAL_SCALE."""
    values = sdp.init_state_dict(model, seed, device)
    last = [f"{n}.convbn2.1.weight" for n, m in model.named_modules() if isinstance(m, BasicBlock)]
    last += [f"dres{i}_1.1.weight" for i in (1, 2, 3, 4)]
    for name in last:
        values[name] = values[name] * RESIDUAL_SCALE
    return values


# What the benchmark asks of a reference module.

def build(model: dict, precision: str | None = None, chunk: int = 8192) -> nn.Module:
    """The network of a configuration's `model` keys, its products at
    `precision` (None: float32; "tf32" or "fp8" for the control). `chunk`
    is accepted for the harness's FLOP count and unused: NNet has no
    deformable sampling to split."""
    return NNet(model, Products(precision))


def answer(net: nn.Module, batch: dict, got: dict | None = None) -> dict:
    """The reference's answer to a request batch (float tensors on the
    net's device), one sample at a time (in eval each sample is
    independent). `got`, the program's answer, is not needed: no part of
    NNet follows the disparity it regressed."""
    inputs = {k: batch[k] for k in ("left", "right", "K", "abvalue")}
    outs = [net({k: v[i:i + 1] for k, v in inputs.items()}) for i in range(len(inputs["left"]))]
    return {k: None if outs[0][k] is None else torch.cat([o[k] for o in outs]) for k in outs[0]}


# Added to a sample's normals' deviation (below) before dividing by it,
# so a field that hardly varies weighs by its absolute gap.
DEVIATION_FLOOR = 0.05


def normal_deviation(normal: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W, 3] unit normals -> [B, 1, 1, 1, 1]: each sample's root
    mean square distance of its normals from their mean over the image."""
    dev = (normal - normal.mean((1, 2, 3), keepdim=True)).square().sum(-1).mean((1, 2, 3)).sqrt()
    return dev.reshape(-1, 1, 1, 1, 1)


def gaps(want: dict, got: dict) -> dict:
    """Each judged output's gap map [B, ...] (None where the program's
    output is missing or of another shape):
    * `disp`: both heads' |program - reference| disparity, each over the
      spread of that head's reference posterior at the pixel (plus
      SPREAD_FLOOR), as `stereodpnet.gaps` judges its one head;
    * `normal`: the unit normals' absolute gap over the sample's
      deviation (`normal_deviation` of the reference's, plus
      DEVIATION_FLOOR). With random weights a sample's normal field is a
      direction common to the image plus what the features add to it; the
      larger the common part, the less any rounding moves the field, and
      its share changes from seed to seed as a posterior's spread does;
    * `prob`: both heads' posteriors' total variation distance at each
      pixel (half the sum over the bins of the probabilities' absolute
      gap, in [0, 1]): a measure of a pixel's whole posterior, however
      peaked, where a gap over the volume's root mean square follows how
      peaked the seed's posteriors are."""
    out = {}
    for key, name in (("pred_depth", "disp"), ("pred_normal", "normal"), ("prob_depth", "prob")):
        w = want.get(key)
        if w is None:
            continue
        g = got.get(key)
        if g is None or tuple(g.shape) != tuple(w.shape):
            out[name] = None
            continue
        d = (g.to(w.device).float() - w).abs()
        if name == "disp":
            d = d / (want["disp_spread"] + SPREAD_FLOOR)
        elif name == "normal":
            d = d / (normal_deviation(w) + DEVIATION_FLOOR)
        else:
            d = d.sum(2) / 2
        out[name] = d
    return out
