"""ANM, the adaptive normal module (counterpart of
`dualpixelface_tpu/models/stereodpnet/normal_module.py`).

From the aggregated cost volume and the regressed disparity:
  1. sample_with_sort: the k disparity planes nearest the predicted disparity;
  2. grid_maker_3d: the normalised 3-D world-coordinate volume;
  3. two deformable 3x3x3 convs over [cost | coords] (kernels K5 and K1);
  4. a shared dilated 2-D conv stack per plane, x4 bilinear upsample,
     sigmoid, mean over planes, mapped to [-1, 1].
The deform stage is channels-last [B, K, h, w, C], the kernels' layout.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from dualpixelface_tpu_torch.ops import geometry
from dualpixelface_tpu_torch.ops.blocks import BatchNorm3d, LeakyReLU
from dualpixelface_tpu_torch.ops.cost_volume import costrange as make_costrange
from dualpixelface_tpu_torch.ops.deform_conv3d import DeformConvPack3D
from dualpixelface_tpu_torch.ops.resize import downsample2d_nearest, resize_linear


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)  # cached: usable in autograd after serving
def _device_planes(values: tuple, device) -> torch.Tensor:
    """The plane values as f32 on the device, copied once (a per-call host
    copy would drain the stream). Callers only read them."""
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def _gather_planes(cost, cr, idx):
    """cost [B, D, H, W, C], idx [B, K, H, W] -> (cost planes, their values)."""
    b, k, h, w = idx.shape
    planes = torch.gather(cost, 1, idx[..., None].expand(b, k, h, w, cost.shape[-1]))
    return planes, _device_planes(tuple(cr.tolist()), cost.device)[idx]


def sample_with_sort(cost: torch.Tensor, disp: torch.Tensor, costrange: np.ndarray, k: int):
    """The k planes nearest `disp`, in ascending order.

    On a uniform grid with even k these are k consecutive planes starting at
    j = clip(floor(f) - (k/2 - 1) - tie, 0, D - k), f = (disp - cr0) / step;
    `tie` (f an exact plane) picks the lower window, as torch.topk's
    first-index preference does. Otherwise the reference's
    topk(1/|costrange - disp|) + sort.

    cost [B, D, H, W, C], disp [B, H, W] -> ([B, K, H, W, C], [B, K, H, W] f32)."""
    cr = np.asarray(costrange, np.float32)
    d = cost.shape[1]
    if d != len(cr):
        raise ValueError(f"cost has {d} planes, costrange {len(cr)}")
    step = float(cr[1] - cr[0]) if d > 1 else 1.0
    if k % 2 != 0 or not np.allclose(np.diff(cr), step):
        return _sample_topk_fallback(cost, disp, cr, k)
    f = (disp.float() - float(cr[0])) / step
    j0 = torch.floor(f)
    tie = (f == j0).float()
    j = torch.clamp(j0 - (k // 2 - 1) - tie, 0, d - k).long()  # [B, H, W]
    idx = j[:, None] + torch.arange(k, device=cost.device).reshape(1, k, 1, 1)
    return _gather_planes(cost, cr, idx)


def _sample_topk_fallback(cost, disp, cr, k):
    """topk of 1/|costrange - disp| over planes (ties to the lower index),
    indices sorted ascending, per-pixel gather."""
    cr = np.asarray(cr, np.float32)
    crt = _device_planes(tuple(cr.tolist()), cost.device)
    diff = torch.abs(crt.reshape(1, -1, 1, 1) - disp[:, None].float())
    score = 1.0 / torch.clamp_min(diff, 1e-30)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    idx = torch.sort(order, dim=1).values
    return _gather_planes(cost, cr, idx)


def grid_maker_3d(K: torch.Tensor, disp_range: torch.Tensor, ab_value: torch.Tensor) -> torch.Tensor:
    """Normalised world-coordinate volume K_q^-1 [u, v, 1] * depth(disp),
    min-max scaled per sample. K [B, 3, 3] full-res intrinsics,
    disp_range [B, D, H, W] quarter-scale, ab_value [B, 2] -> [B, D, H, W, 3]."""
    b, d, h, w = disp_range.shape
    K = K.float()
    K_q = torch.cat([K[:, :2] / 4.0, K[:, 2:]], dim=1)
    dev = disp_range.device
    yg, xg = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([xg, yg, torch.ones_like(xg)], 0).reshape(3, h * w)
    # inv_ex: no check of the factorisation's status, which on the card would
    # wait for the device (the JAX package's inv does not check either)
    warp = torch.einsum("bij,jn->bin", torch.linalg.inv_ex(K_q).inverse, grid).reshape(b, 3, h, w)
    depth = geometry.disp2depth(disp_range.float(), ab_value)
    vol = warp[:, :, None] * depth[:, None]  # [B, 3, D, H, W]
    vmin = vol.reshape(b, -1).amin(-1).reshape(b, 1, 1, 1, 1)
    vmax = vol.reshape(b, -1).amax(-1).reshape(b, 1, 1, 1, 1)
    vol = (vol - vmin) / (vmax - vmin + 1e-6)
    return torch.movedim(vol, 1, -1)


def _bn_channels_last(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(bn(torch.movedim(x, -1, 1)), 1, -1)


class ANM(nn.Module):
    def __init__(self, option, mindisp: float, maxdisp: float):
        super().__init__()
        opt = option.model
        c = opt.inplanes
        if not (opt.use_deform and opt.use_sampling):
            raise NotImplementedError("ANM without use_deform/use_sampling is not ported yet (ROADMAP.md queue 1)")
        self.k = int(opt.dsample_num)
        self.costrange = make_costrange(mindisp, maxdisp, opt.level)
        impl = opt.get("deform_impl", "pallas")
        oclamp = bool(opt.get("deform_offset_clamp", False))
        self.deform_conv1 = DeformConvPack3D(c + 3, 2 * c, impl, oclamp)
        self.deform_conv2 = DeformConvPack3D(2 * c, 2 * c, impl, oclamp)
        self.act1 = nn.Sequential(BatchNorm3d(2 * c), nn.ReLU())
        self.act2 = nn.Sequential(BatchNorm3d(2 * c), nn.ReLU())
        plan = [(3 * c, 1), (3 * c, 2), (2 * c, 4), (2 * c, 8), (c, 1), (3, 1)]
        chans = [2 * c] + [ch for ch, _ in plan]
        self.n_convs = nn.ModuleList([
            nn.Sequential(nn.Conv2d(chans[i], ch, 3, padding=dil, dilation=dil, bias=False), LeakyReLU(0.1))
            for i, (ch, dil) in enumerate(plan)
        ])

    def forward(self, cost, disp_map, batch):
        """cost [B, C, D, h, w] (channels-first), disp_map [B, H, W].
        Returns (normal [B, H, W, 3], offset1, offset2)."""
        cost = torch.movedim(cost, 1, -1)  # [B, D, h, w, C]
        b = cost.shape[0]
        disp = downsample2d_nearest(disp_map[..., None], 4)[..., 0] * 0.25
        cost_s, disp_range = sample_with_sort(cost, disp, self.costrange, self.k)
        coord = grid_maker_3d(batch["K"], disp_range, batch["abvalue"])
        fv = torch.cat([cost_s, coord.to(cost_s.dtype)], dim=-1).contiguous()  # [B, K, h, w, C+3]

        fv, offset1 = self.deform_conv1(fv)
        fv = _bn_channels_last(self.act1, fv).contiguous()
        fv, offset2 = self.deform_conv2(fv)
        fv = _bn_channels_last(self.act2, fv)

        _, ks, hh, ww, cc = fv.shape
        feats = torch.movedim(fv.reshape(b * ks, hh, ww, cc), -1, 1)  # [B*K, C, h, w]
        for conv in self.n_convs:
            feats = conv(feats)
        feats = torch.sigmoid(resize_linear(feats, (4 * hh, 4 * ww), (2, 3)))  # [B*K, 3, H, W]
        feats = feats.reshape(b, ks, 3, 4 * hh, 4 * ww).mean(dim=1)
        normal = torch.movedim(feats * 2.0 - 1.0, 1, -1)  # [B, H, W, 3]
        return normal, offset1, offset2

