"""Plain PyTorch reference of StereoDPNet: the forward, the two training
losses and the seeded init, written from the model's equations for the
benchmark's correctness check. It imports nothing of the program under
test.

Both configurations run through it: `stereodpnet` (exact ASM attention,
unbounded deformable sampling, the soft-argmin's probability volume
returned) and `stereodpnet_plus` (the attention head hoisted before the
shifts, the deformable sampling windowed with its offsets clamped, the
probability volume not returned). Every step runs in float32 on the
channels-first layout with library calls (F.conv*, F.interpolate,
F.batch_norm, plain matmuls), so it needs no kernel.

`Products` carries the precision of every product (convolutions and
matrix products): exact float32, or, for the correctness control, its
operands rounded to TF32 or to fp8 (e4m3, one scale per tensor). The
state_dict names are the reference implementation's, so one state_dict
loads into this module and into the program alike.

What the benchmark asks of a reference module, found by the name a
configuration gives under `reference`: `build`, `init_state_dict`,
`losses` (a train mix), `answer` and `gaps` (a serving mix); see the end
of this file.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

AP = 3  # the windowed sampling's half window, in voxels along H and W
EPS_WINDOW = 1.0 / 1024.0
TAPS = 27


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale for the tensor (its
    largest magnitude at e4m3's largest finite, 448)."""
    scale = 448.0 / t.detach().abs().amax().float().clamp_min(1e-30)
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDING = {"tf32": round_tf32, "fp8": round_fp8}


class Products:
    """The model's products. `mode` None computes them in float32; "tf32"
    or "fp8" rounds both operands of each first (forward only; the
    gradient passes the rounding unchanged)."""

    def __init__(self, mode: str | None = None):
        if mode is not None and mode not in ROUNDING:
            raise ValueError(f"product precision {mode!r}")
        self.mode = mode
        self._operators: dict = {}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return t
        r = ROUNDING[self.mode](t.detach())
        return t + (r - t).detach()

    def conv(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        w, b = self.q(m.weight), m.bias
        if isinstance(m, nn.ConvTranspose3d):
            return F.conv_transpose3d(self.q(x), w, b, m.stride, m.padding, m.output_padding, m.groups, m.dilation)
        fn = F.conv2d if isinstance(m, nn.Conv2d) else F.conv3d
        return fn(self.q(x), w, b, m.stride, m.padding, m.dilation, m.groups)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def phase_operator(self, h: int, deltas: tuple, device) -> torch.Tensor:
        """[D, H, H]: the circular Fourier shift of a length-H signal by each
        delta, IDFT . diag(exp(2 pi i delta k / H)) . DFT, its real part."""
        key = (h, deltas, str(device))
        if key not in self._operators:
            freqs = np.fft.fftfreq(h) * h
            dft = np.fft.fft(np.eye(h))
            idft = np.conj(dft).T / h
            phase = np.exp(2j * np.pi * (np.asarray(deltas)[:, None] / h) * freqs[None, :])
            mats = np.einsum("yk,dk,kx->dyx", idft, phase, dft, optimize=True).real.astype(np.float32)
            self._operators[key] = torch.as_tensor(mats, device=device)
        return self._operators[key]


def run(P: Products, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`m` on x, its convolutions through P (a Sequential step by step)."""
    if isinstance(m, nn.Sequential):
        for child in m:
            x = run(P, child, x)
        return x
    if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
        return P.conv(m, x)
    return m(x)


class PReLU(nn.Module):
    """One slope `weight` [1]; where(x >= 0, x, a x)."""

    def __init__(self, init: float = 0.05):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class LeakyReLU(nn.Module):
    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.slope)


class InstanceNorm(nn.Module):
    """Affine `weight`, `bias` [C]; normalised with statistics given."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, mean, var):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight.reshape(shape) + self.bias.reshape(shape)


def conv_bn(cin, cout, k=3, s=1, pad=None, dil=1):
    return nn.Sequential(nn.Conv2d(cin, cout, k, s, dil * (k - 1) // 2 if pad is None else pad, dil, bias=False),
                         nn.BatchNorm2d(cout))


def conv_bn3d(cin, cout, s=1):
    return nn.Sequential(nn.Conv3d(cin, cout, 3, s, 1, bias=False), nn.BatchNorm3d(cout))


class SeparableConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.depthwise = nn.Conv2d(c, c, 3, 1, 1, groups=c, bias=False)
        self.pointwise = nn.Conv2d(c, c, 1, bias=False)
        self.bn = nn.BatchNorm2d(c)
        self.prelu = PReLU()

    def forward(self, x, P):
        return self.prelu(self.bn(P.conv(self.pointwise, P.conv(self.depthwise, x))))


class DPBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int, expand: int):
        super().__init__()
        self.conv1 = nn.Sequential(conv_bn(cin, c, pad=1), PReLU())
        self.conv2 = nn.Sequential(conv_bn(c, c, pad=1), PReLU())
        self.conv_dilate = nn.ModuleList([conv_bn(c, c, dil=2 * i + 1) for i in range(3)])
        self.conv3 = conv_bn(3 * c, c, pad=1)
        self.prelu = PReLU()
        self.conv4 = nn.Sequential(conv_bn(c, expand * c, s=stride, dil=2), PReLU())
        self.conv5 = SeparableConv(expand * c)
        self.conv_skip = nn.Conv2d(cin, expand * c, 1, stride)

    def forward(self, x, P):
        out1 = run(P, self.conv1, x)
        out2 = run(P, self.conv2, out1)
        out2 = run(P, self.conv3, torch.cat([run(P, m, out2) for m in self.conv_dilate], 1))
        out = self.conv5(run(P, self.conv4, self.prelu(out2 + out1)), P)
        return out + P.conv(self.conv_skip, x)


def upsample(x, factor):
    """x [N, C, *S] by `factor` along S, align-corners linear."""
    mode = {2: "bilinear", 3: "trilinear"}[x.ndim - 2]
    return F.interpolate(x, size=tuple(factor * n for n in x.shape[2:]), mode=mode, align_corners=True)


class FPN(nn.Module):
    def __init__(self, chans, c):
        super().__init__()
        self.inner_blocks = nn.ModuleList([nn.Conv2d(ci, c, 1) for ci in chans])
        self.layer_blocks = nn.ModuleList([nn.Conv2d(c, c, 3, padding=1) for _ in chans])

    def forward(self, levels, P):
        lat = [P.conv(m, x) for m, x in zip(self.inner_blocks, levels)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], size=lat[i].shape[2:], mode="nearest")
        return [P.conv(m, x) for m, x in zip(self.layer_blocks, lat)]


class FeatureExtraction(nn.Module):
    """[N, 3, H, W] -> [N, C, H/4, W/4]."""

    def __init__(self, c: int):
        super().__init__()
        self.firstconv = nn.Sequential(conv_bn(3, c, s=2, pad=1), nn.ReLU(), conv_bn(c, c, pad=1), nn.ReLU(),
                                       conv_bn(c, c, pad=1), nn.ReLU())
        self.block1 = DPBlock(c, c, 2, 1)
        self.interblock1 = nn.ModuleList([DPBlock(c, c, 1, 1)])
        self.block2 = DPBlock(c, c, 2, 2)
        self.interblock2 = nn.ModuleList([DPBlock(2 * c, 2 * c, 1, 1)])
        self.block3 = DPBlock(2 * c, 2 * c, 2, 2)
        self.fpn = FPN((c, 2 * c, 4 * c), c)
        self.lastconv = nn.Sequential(conv_bn(3 * c, 2 * c, pad=1), nn.ReLU(), conv_bn(2 * c, c, pad=1), nn.ReLU())

    def forward(self, x, P):
        out1 = self.block1(run(P, self.firstconv, x), P)
        out2 = self.block2(self.interblock1[0](out1, P), P)
        out3 = self.block3(self.interblock2[0](out2, P), P)
        high, mid, low = self.fpn([out1, out2, out3], P)
        return run(P, self.lastconv, torch.cat([high, upsample(mid, 2), upsample(low, 4)], 1))


def shift_rows(x, k: int, axis: int):
    """dst[y] = src[y + k] along `axis`, zero where y + k is outside."""
    n = x.shape[axis]
    if k == 0:
        return x
    if abs(k) >= n:
        return torch.zeros_like(x)
    zeros = torch.zeros_like(x.narrow(axis, 0, abs(k)))
    if k > 0:
        return torch.cat([x.narrow(axis, k, n - k), zeros], axis)
    return torch.cat([zeros, x.narrow(axis, 0, n + k)], axis)


def shift_modes(P, x, deltas, modes):
    """x [B, C, H, W] shifted along H by every delta: nearest (round half
    to even), linear (zero outside), Fourier (circular); each mode
    [B, C, D, H, W]."""
    out = []
    if modes["nearest"]:
        out.append(torch.stack([shift_rows(x, int(np.round(d)), 2) for d in deltas], 2))
    if modes["bilinear"]:
        planes = []
        for d in deltas:
            lo = math.floor(d)
            frac = d - lo
            planes.append((1 - frac) * shift_rows(x, lo, 2) + frac * shift_rows(x, lo + 1, 2))
        out.append(torch.stack(planes, 2))
    if modes["phase"]:
        ops = P.phase_operator(x.shape[2], tuple(float(d) for d in deltas), x.device).to(x.dtype)
        rows = P.q(x.transpose(2, 3))  # [B, C, W, H]
        y = torch.einsum("dyh,bcwh->bcdyw", P.q(ops), rows)
        out.append(y)
    return out


class MaskingAttention(nn.Module):
    """Scores each shift mode by a mask head (conv 3x3, BatchNorm, ReLU,
    conv 1x1, an InstanceNorm whose statistics pool the modes), then a
    sigmoid and a softmax over the modes gate the shifted features, and
    their mean over the modes is the plane. `exact`: the head runs on every
    shifted plane and mode; otherwise once, before the shifts."""

    def __init__(self, c: int):
        super().__init__()
        self.normalize = InstanceNorm(c)
        self.mask_convs = nn.Sequential(nn.Conv3d(c, c, (1, 3, 3), padding=(0, 1, 1), bias=False), nn.BatchNorm2d(c),
                                        nn.ReLU(), nn.Sequential(nn.Conv3d(c, c, 1, bias=False), self.normalize))

    def forward(self, x, P, shift, exact: bool):
        conv0, bn, _, tail = self.mask_convs
        ys = shift(x)
        if exact:
            m = len(ys)
            b, c, d, h, w = ys[0].shape
            mask = P.conv(conv0, torch.cat(ys, 0))
            mask = torch.relu(bn(mask.reshape(m * b, c, d * h, w))).reshape(m * b, c, d, h, w)
            masks = list(P.conv(tail[0], mask).chunk(m, 0))
        else:
            w0, w1 = conv0.weight[:, :, 0], tail[0].weight[:, :, 0]
            mask = F.conv2d(P.q(x), P.q(w0), padding=1)
            mask = F.conv2d(P.q(torch.relu(bn(mask))), P.q(w1))
            masks = shift(mask)
        hw = masks[0].shape[-2] * masks[0].shape[-1] * len(masks)
        mean = sum(t.sum((3, 4), keepdim=True) for t in masks) / hw
        var = sum(t.square().sum((3, 4), keepdim=True) for t in masks) / hw - mean.square()
        scores = torch.stack([torch.sigmoid(self.normalize(t, mean, var)) for t in masks])
        weights = torch.softmax(scores, 0)
        return (torch.stack(ys) * weights).mean(0)


class ASMCostVolume(nn.Module):
    def __init__(self, c, deltas, modes, exact):
        super().__init__()
        self.deltas, self.modes, self.exact = deltas, modes, exact
        self.attention_layer = MaskingAttention(c)

    def forward(self, ref, tar, P):
        fwd = lambda t: shift_modes(P, t, self.deltas, self.modes)  # noqa: E731
        bwd = lambda t: shift_modes(P, t, [-d for d in self.deltas], self.modes)  # noqa: E731
        return torch.cat([self.attention_layer(ref, P, fwd, self.exact),
                          self.attention_layer(tar, P, bwd, self.exact)], 1)


class Hourglass(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Sequential(conv_bn3d(c, 2 * c, 2), nn.ReLU())
        self.conv2 = conv_bn3d(2 * c, 2 * c)
        self.conv3 = nn.Sequential(conv_bn3d(2 * c, 2 * c, 2), nn.ReLU())
        self.conv4 = nn.Sequential(conv_bn3d(2 * c, 2 * c), nn.ReLU())
        self.conv5 = nn.Sequential(nn.ConvTranspose3d(2 * c, 2 * c, 3, 2, 1, 1, bias=False), nn.BatchNorm3d(2 * c))
        self.conv6 = nn.Sequential(nn.ConvTranspose3d(2 * c, c, 3, 2, 1, 1, bias=False), nn.BatchNorm3d(c))

    def forward(self, x, presqu, postsqu, P):
        pre = run(P, self.conv2, run(P, self.conv1, x))
        pre = torch.relu(pre if postsqu is None else pre + postsqu)
        up = run(P, self.conv5, run(P, self.conv4, run(P, self.conv3, pre)))
        post = torch.relu(up + (pre if presqu is None else presqu))
        return run(P, self.conv6, post), pre, post


class Aggregation(nn.Module):
    """Three hourglasses over the cost volume; per head (three in
    training, the last in eval) the coarse logits [B, D, h, w] and the
    feature volume before its classifier."""

    def __init__(self, c):
        super().__init__()
        self.dres0 = nn.Sequential(conv_bn3d(2 * c, c), nn.ReLU(), conv_bn3d(c, c), nn.ReLU())
        self.dres1 = nn.Sequential(conv_bn3d(c, c), nn.ReLU(), conv_bn3d(c, c))
        self.dres2, self.dres3, self.dres4 = Hourglass(c), Hourglass(c), Hourglass(c)
        for i in (1, 2, 3):
            setattr(self, f"classif{i}", nn.Sequential(conv_bn3d(c, c), nn.ReLU(), nn.Conv3d(c, 1, 3, 1, 1, bias=False)))

    def forward(self, cost, P):
        c0 = run(P, self.dres0, cost)
        c0 = run(P, self.dres1, c0) + c0
        o1, pre1, post1 = self.dres2(c0, None, None, P)
        o1 = o1 + c0
        o2, _, post2 = self.dres3(o1, pre1, post1, P)
        o2 = o2 + c0
        o3, _, _ = self.dres4(o2, pre1, post2, P)
        o3 = o3 + c0
        k1 = run(P, self.classif1, o1)
        k2 = run(P, self.classif2, o2) + k1
        k3 = run(P, self.classif3, o3) + k2
        if self.training:
            return [k3[:, 0], k2[:, 0], k1[:, 0]], [o3, o2, o1]
        return [k3[:, 0]], [o3]


def trilinear(x, pos_d, pos_h, pos_w):
    """x [B, D, H, W, C] at float positions [B, n, K] (voxel units): the
    8-corner linear interpolation, a corner outside the volume zero:
    [B, n, K, C]."""
    b, d, h, w, c = x.shape
    flat = x.reshape(b * d * h * w, c)
    base = (torch.arange(b, device=x.device) * (d * h * w)).reshape(b, 1, 1)
    lo = [torch.floor(p) for p in (pos_d, pos_h, pos_w)]
    out = 0.0
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                idx = [l + s for l, s in zip(lo, (cz, cy, cx))]
                wgt = 1.0
                for i, s, p, l in zip(idx, (cz, cy, cx), (pos_d, pos_h, pos_w), lo):
                    wgt = wgt * ((p - l) if s else (1.0 - (p - l)))
                ok = (idx[0] >= 0) & (idx[0] < d) & (idx[1] >= 0) & (idx[1] < h) & (idx[2] >= 0) & (idx[2] < w)
                lin = (idx[0].clamp(0, d - 1) * h + idx[1].clamp(0, h - 1)) * w + idx[2].clamp(0, w - 1)
                vals = flat.index_select(0, (lin.long() + base).reshape(-1)).reshape(*lin.shape, c)
                out = out + (wgt * ok)[..., None] * vals
    return out


def _positions(offset, shape, rows, windowed):
    """Sampling positions [B, n, 27] per axis of the output voxels `rows`
    (flat over D x H x W): voxel - 1 + tap + offset; windowed, H and W
    clamped to [out - AP, out + AP + 1 - EPS]."""
    d, h, w = shape
    dev = offset.device
    z, y, x = (t.reshape(-1)[rows] for t in torch.meshgrid(*(torch.arange(n, device=dev) for n in shape),
                                                            indexing="ij"))
    kz, ky, kx = (t.reshape(-1) for t in torch.meshgrid(*(torch.arange(3, device=dev),) * 3, indexing="ij"))
    off = offset.reshape(offset.shape[0], -1, TAPS, 3)
    pos = [(o[:, None] - 1 + k[None]).float() + off[..., a] for a, (o, k) in enumerate(((z, kz), (y, ky), (x, kx)))]
    if windowed:
        for a, o in ((1, y), (2, x)):
            o = o.float()[None, :, None]
            pos[a] = torch.minimum(torch.maximum(pos[a], o - AP), o + AP + 1 - EPS_WINDOW)
    return pos


class _DeformConv(torch.autograd.Function):
    """x [B, D, H, W, C], offset [B, D, H, W, 81], wmat [27 C, Co]: the
    samples times wmat, in blocks of `chunk` output voxels. The backward
    samples each block again and takes both products of the gradient, so
    no samples are kept between the passes."""

    @staticmethod
    def forward(ctx, x, offset, wmat, windowed, chunk, P):
        ctx.save_for_backward(x, offset, wmat)
        ctx.args = windowed, chunk, P
        b, d, h, w, c = x.shape
        n = d * h * w
        off = offset.reshape(b, n, -1)
        out = []
        for r in torch.arange(n, device=x.device).split(chunk):
            pos = _positions(off[:, r], (d, h, w), r, windowed)
            out.append(P.mm(trilinear(x, *pos).reshape(b * len(r), TAPS * c), wmat).reshape(b, len(r), -1))
        return torch.cat(out, 1).reshape(b, d, h, w, -1)

    @staticmethod
    def backward(ctx, g):
        x, offset, wmat = ctx.saved_tensors
        windowed, chunk, _ = ctx.args
        b, d, h, w, c = x.shape
        n = d * h * w
        off, gf = offset.reshape(b, n, -1), g.reshape(b, n, -1)
        gx, gw, goff = torch.zeros_like(x), torch.zeros_like(wmat), torch.zeros_like(off)
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            for r in torch.arange(n, device=x.device).split(chunk):
                ol = off[:, r].detach().requires_grad_(True)
                cols = trilinear(xl, *_positions(ol, (d, h, w), r, windowed)).reshape(b * len(r), TAPS * c)
                gr = gf[:, r].reshape(b * len(r), -1)
                gw += cols.detach().t() @ gr
                dx, do = torch.autograd.grad(cols, (xl, ol), gr @ wmat.t())
                gx += dx
                goff[:, r] = do
        return gx, goff.reshape(offset.shape), gw, None, None, None


class DeformConvPack3D(nn.Module):
    """Channels-last deformable 3x3x3 conv that predicts its own offsets
    (an 81-channel 3x3x3 conv, tap k = (kd 3 + kh) 3 + kw at channels 3k +
    (dD, dH, dW)); `weight` [Co, Cin, 3, 3, 3], `bias` [Co]."""

    def __init__(self, cin, cout, windowed: bool, clamp: bool, chunk: int):
        super().__init__()
        self.windowed, self.clamp, self.chunk = windowed, clamp, chunk
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.conv_offset = nn.Conv3d(cin, 3 * TAPS, 3, 1, 1)

    def forward(self, x, P):
        offset = torch.movedim(P.conv(self.conv_offset, torch.movedim(x, -1, 1)), 1, -1)
        if self.clamp:  # each H/W position inside the window, the gradient passed straight through
            kz, ky, kx = np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij")
            big = np.full(TAPS, 1e9)
            lo = np.stack([-big, -AP - (ky.ravel() - 1), -AP - (kx.ravel() - 1)], -1).ravel()
            hi = np.stack([big, AP + 1 - EPS_WINDOW - (ky.ravel() - 1), AP + 1 - EPS_WINDOW - (kx.ravel() - 1)],
                          -1).ravel()
            lo, hi = (torch.as_tensor(v, dtype=offset.dtype, device=offset.device) for v in (lo, hi))
            offset = offset + (torch.minimum(torch.maximum(offset, lo), hi) - offset).detach()
        wmat = self.weight.permute(2, 3, 4, 1, 0).reshape(-1, self.weight.shape[0])
        return _DeformConv.apply(x, offset, wmat, self.windowed, self.chunk, P) + self.bias


class ANM(nn.Module):
    """Normals from the aggregated feature volume and the disparity: the
    four planes nearest each pixel's disparity, their 3-D coordinates, two
    deformable convs, a dilated 2-D conv stack per plane, x4 upsampling,
    sigmoid, the mean over the planes, mapped to [-1, 1]."""

    def __init__(self, c, planes, k, windowed, clamp, chunk):
        super().__init__()
        self.planes, self.k = planes, k
        self.deform_conv1 = DeformConvPack3D(c + 3, 2 * c, windowed, clamp, chunk)
        self.deform_conv2 = DeformConvPack3D(2 * c, 2 * c, windowed, clamp, chunk)
        self.act1 = nn.Sequential(nn.BatchNorm3d(2 * c), nn.ReLU())
        self.act2 = nn.Sequential(nn.BatchNorm3d(2 * c), nn.ReLU())
        plan = [(3 * c, 1), (3 * c, 2), (2 * c, 4), (2 * c, 8), (c, 1), (3, 1)]
        chans = [2 * c] + [ch for ch, _ in plan]
        self.n_convs = nn.ModuleList([nn.Sequential(nn.Conv2d(chans[i], ch, 3, padding=dl, dilation=dl, bias=False),
                                                    LeakyReLU(0.1)) for i, (ch, dl) in enumerate(plan)])

    def forward(self, feats, disp, K, ab, P):
        cost = torch.movedim(feats, 1, -1)  # [B, D, h, w, C]
        b, nd, h, w, c = cost.shape
        planes = torch.as_tensor(self.planes, dtype=cost.dtype, device=cost.device)
        step = float(self.planes[1] - self.planes[0])
        # the k planes nearest the quarter-scale disparity, ascending; a
        # disparity on a plane takes the lower window
        f = (disp[:, ::4, ::4] * 0.25 - float(self.planes[0])) / step
        j0 = torch.floor(f)
        j = torch.clamp(j0 - (self.k // 2 - 1) - (f == j0).float(), 0, nd - self.k).long()
        idx = j[:, None] + torch.arange(self.k, device=cost.device).reshape(1, -1, 1, 1)
        sampled = torch.gather(cost, 1, idx[..., None].expand(b, self.k, h, w, c))
        # normalised 3-D coordinates of each sampled plane
        kq = torch.cat([K[:, :2] / 4.0, K[:, 2:]], 1)
        yy, xx = torch.meshgrid(torch.arange(h, device=cost.device, dtype=cost.dtype),
                                torch.arange(w, device=cost.device, dtype=cost.dtype), indexing="ij")
        pix = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, -1)
        rays = (torch.linalg.inv(kq) @ pix).reshape(b, 3, 1, h, w)
        depth = ab[:, 1].reshape(b, 1, 1, 1) / (planes[idx] - ab[:, 0].reshape(b, 1, 1, 1))
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        vol = rays * depth[:, None]
        vmin = vol.reshape(b, -1).amin(1).reshape(b, 1, 1, 1, 1)
        vmax = vol.reshape(b, -1).amax(1).reshape(b, 1, 1, 1, 1)
        coord = torch.movedim((vol - vmin) / (vmax - vmin + 1e-6), 1, -1)
        fv = torch.cat([sampled, coord], -1)
        fv = torch.movedim(run(P, self.act1, torch.movedim(self.deform_conv1(fv, P), -1, 1)), 1, -1)
        fv = torch.movedim(run(P, self.act2, torch.movedim(self.deform_conv2(fv, P), -1, 1)), 1, -1)
        x = torch.movedim(fv.reshape(b * self.k, h, w, -1), -1, 1)
        for m in self.n_convs:
            x = run(P, m, x)
        x = torch.sigmoid(upsample(x, 4)).reshape(b, self.k, 3, 4 * h, 4 * w).mean(1)
        return torch.movedim(x * 2.0 - 1.0, 1, -1)


class StereoDPNet(nn.Module):
    """The whole network. forward(batch) -> pred_depth [B, n, H, W] (the
    disparity of each head: n = 3 in training, 1 in eval), prob_depth
    [B, n, 4 level, H, W] (or None, `return_prob` off), pred_normal
    [B, 1, H, W, 3], disp_spread [B, 1, H, W] (the first head's
    probabilities' standard deviation about its disparity)."""

    def __init__(self, model: dict, products: Products | None = None, chunk: int = 8192):
        super().__init__()
        self.products = products or Products()
        c, level = model["inplanes"], model["level"]
        lo, hi = model["mindisp"], model["maxdisp"]
        self.deltas = [float(v) for v in np.arange(level) * ((hi / 4.0 - lo / 4.0) / level) + lo / 4.0]
        n_bins = 4 * level
        self.bins = np.arange(n_bins) * ((hi - lo) / n_bins) + lo
        self.return_prob = not model.get("fused_regression", False)
        # the windowed sampling holds at most 4 planes; more take the unbounded one
        windowed = model["deform_impl"] == "pallas" and int(model["dsample_num"]) <= 4
        modes = {k: bool(model[k]) for k in ("nearest", "bilinear", "phase")}
        self.feature_extraction = FeatureExtraction(c)
        self.cost_volume = ASMCostVolume(c, self.deltas, modes, exact=not model.get("fast_attention", False))
        self.aggregation = Aggregation(c)
        self.normal_estimator = ANM(c, self.deltas, int(model["dsample_num"]), windowed,
                                    bool(model.get("deform_offset_clamp", False)), chunk)

    def regress(self, logits):
        """Coarse logits [B, D, h, w] -> (disparity [B, 4h, 4w], the
        probabilities [B, 4D, 4h, 4w], their spread about the disparity
        [B, 4h, 4w]): x4 trilinear, softmax, expectation."""
        prob = torch.softmax(upsample(logits[:, None], 4)[:, 0], 1)
        bins = torch.as_tensor(self.bins, dtype=prob.dtype, device=prob.device).reshape(1, -1, 1, 1)
        disp = (prob * bins).sum(1)
        spread = (prob * (bins - disp[:, None]).square()).sum(1).clamp_min(0).sqrt()
        return disp, prob, spread

    def forward(self, batch, anm_disparity=None):
        """`anm_disparity` [B, H, W], where given, picks the ANM's planes in
        place of the network's own disparity (the check follows the
        program's plane choice with it)."""
        P = self.products
        left, right = (torch.movedim(batch[k], -1, 1) for k in ("left", "right"))
        b = left.shape[0]
        both = self.feature_extraction(torch.cat([left, right]), P)
        cost = self.cost_volume(both[:b], both[b:], P)
        logits, feats = self.aggregation(cost, P)
        disps, probs, spreads = zip(*(self.regress(t) for t in logits))
        pick = disps[0] if anm_disparity is None else anm_disparity
        normal = self.normal_estimator(feats[0], pick, batch["K"], batch["abvalue"], P)
        return {"pred_depth": torch.stack(disps, 1),
                "prob_depth": torch.stack(probs, 1) if self.return_prob else None,
                "pred_normal": normal[:, None], "disp_spread": spreads[0][:, None]}


def losses(model: dict, results: dict, batch: dict) -> dict:
    """The training losses: per head the masked smooth-L1 of the disparity
    against the batch's, weighted by `loss_weight`; the masked mean over
    the normal's three components of 1 - p_c g_c, both normalised;
    final = lambdas . (smoothL1, cosine)."""
    mask = (batch["mask"] > 0).float()
    pred = results["pred_depth"]
    weights = list(model["loss_weight"]) if pred.shape[1] > 1 else [1.0]
    l1 = 0.0
    for i, wgt in enumerate(weights):
        a = (pred[:, i] - batch["disp"]).abs()
        l1 = l1 + wgt * (torch.where(a < 1.0, 0.5 * a * a, a - 0.5) * mask).sum() / mask.sum().clamp_min(1e-8)

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-6)

    sim = (unit(results["pred_normal"][:, 0]) * unit(batch["normal"])).clamp(-1.0, 1.0)
    m3 = mask[..., None].expand(sim.shape)
    cos = ((1.0 - sim) * m3).sum() / m3.sum().clamp_min(1e-8)
    lam = model["lambdas"]
    return {"smoothL1_loss": l1, "cosine_loss": cos, "final_loss": lam[0] * l1 + lam[1] * cos}


# The offset heads' init: N(0, (OFFSET_WEIGHT / sqrt(fan_in))^2) weights and
# N(0, OFFSET_BIAS^2) biases, a quarter of the program's seeded init
# (`serve.seeded_state_dict`). At its full scale bf16's rounding moves the
# normals of random weights nearly as far as fp8's, and the normals could
# not be held to a limit in the bf16 cell (PERF.md).
OFFSET_WEIGHT = 0.5
OFFSET_BIAS = 0.25


def init_state_dict(model: nn.Module, seed: int, device) -> dict:
    """Seeded weights for `model`'s state_dict, drawn on `device` in two
    calls (one normal, one uniform): every convolution N(0, 2 / n), n its
    kernel volume times its output channels, bias 0; norms at identity
    (running statistics 0 and 1); the deformable convs U(+-1/sqrt(fan_in));
    their offset heads as OFFSET_WEIGHT and OFFSET_BIAS say."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    leaves = dict(model.named_parameters())
    leaves.update(model.named_buffers())
    offset_heads = {id(m.conv_offset) for m in model.modules() if isinstance(m, DeformConvPack3D)}
    recipe = {}  # name -> (draw, scale, constant)
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            fan_in = math.prod(m.weight.shape[1:])
            if id(m) in offset_heads:
                recipe[p + "weight"] = ("normal", OFFSET_WEIGHT / math.sqrt(fan_in), 0.0)
                recipe[p + "bias"] = ("normal", OFFSET_BIAS, 0.0)
                continue
            out = m.weight.shape[1] if isinstance(m, nn.ConvTranspose3d) else m.weight.shape[0]
            recipe[p + "weight"] = ("normal", math.sqrt(2.0 / (math.prod(m.weight.shape[2:]) * out)), 0.0)
            if m.bias is not None:
                recipe[p + "bias"] = ("const", 0.0, 0.0)
        elif isinstance(m, DeformConvPack3D):
            bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
            recipe[p + "weight"] = ("uniform", bound, 0.0)
            recipe[p + "bias"] = ("uniform", bound, 0.0)
    counts = {"normal": 0, "uniform": 0}
    for name, t in leaves.items():
        draw = recipe.get(name, ("const", 0.0, 0.0))[0]
        if draw in counts:
            counts[draw] += t.numel()
    pools = {"normal": torch.randn(counts["normal"], generator=gen, device=device),
             "uniform": torch.rand(counts["uniform"], generator=gen, device=device) * 2.0 - 1.0}
    used = {"normal": 0, "uniform": 0}
    values = {}
    for name, t in leaves.items():
        draw, scale, _ = recipe.get(name, ("const", 0.0, 0.0))
        if draw in pools:
            n = t.numel()
            values[name] = (pools[draw][used[draw]:used[draw] + n] * scale).reshape(t.shape)
            used[draw] += n
        elif name.endswith(("running_var", "weight")) and not name.endswith("conv_offset.weight"):
            fill = 0.05 if t.numel() == 1 and isinstance(model.get_submodule(name.rsplit(".", 1)[0]), PReLU) else 1.0
            values[name] = torch.full(t.shape, fill, device=device)
        else:
            values[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    by_id = {id(t): values[n] for n, t in leaves.items()}
    return {k: by_id[id(t)] for k, t in model.state_dict(keep_vars=True).items()}


# What the benchmark asks of a reference module.

def build(model: dict, precision: str | None = None, chunk: int = 8192) -> nn.Module:
    """The network of a configuration's `model` keys, its products at
    `precision` (None: float32; "tf32" or "fp8" for the control)."""
    return StereoDPNet(model, Products(precision), chunk)


def answer(net: nn.Module, batch: dict, got: dict | None = None) -> dict:
    """The reference's answer to a request batch (float tensors on the
    net's device), one sample at a time (in eval each sample is
    independent). Where the program's answer `got` is given, the ANM takes
    its planes where the program's disparity puts them: the plane choice
    is a floor, and a rounding-sized move of a disparity on a plane
    boundary swaps the planes of a whole neighbourhood. The disparity is
    judged on its own (`gaps`), as a served token is before the tokens
    that follow it."""
    inputs = {k: batch[k] for k in ("left", "right", "K", "abvalue")}
    b = len(inputs["left"])
    picks = None if got is None else got.get("pred_depth")
    if picks is not None and (picks.dim() != 4 or tuple(picks.shape[::2]) != (b, inputs["left"].shape[1])):
        picks = None
    if picks is not None:
        picks = picks[:, 0].to(inputs["left"].device).float()
    outs = [net({k: v[i:i + 1] for k, v in inputs.items()}, anm_disparity=None if picks is None else picks[i:i + 1])
            for i in range(b)]
    return {k: None if outs[0][k] is None else torch.cat([o[k] for o in outs]) for k in outs[0]}


# Disparity units added to a pixel's posterior spread before dividing by
# it: a tenth of the bins' spacing (0.5), so a pixel whose soft-argmin is
# saturated in both runs weighs by its absolute gap.
SPREAD_FLOOR = 0.05


def gaps(want: dict, got: dict) -> dict:
    """Each judged output's gap map [B, ...] (None where the program's
    output is missing or of another shape):
    * `disp`: |program - reference| disparity over the spread of the
      reference's soft-argmin posterior at the pixel (plus SPREAD_FLOOR): a
      pixel whose posterior is wide or split between far bins moves with
      its logits' rounding by that spread, one whose posterior is
      saturated does not, and random weights mix the two in proportions
      that change from seed to seed;
    * `normal`: the normals' absolute gap (their components lie in
      [-1, 1]);
    * `prob`: the probability volume's gap over the reference's root mean
      square (`stereodpnet` only)."""
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
        elif name == "prob":
            d = d / w.square().mean().sqrt().clamp_min(1e-30)
        out[name] = d
    return out
