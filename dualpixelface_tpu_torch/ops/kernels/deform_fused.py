"""K1: deformable 3x3x3 convolution, stride 1, pad 1, NDHWC (the ANM
deform convs), windowed or unbounded; K2: its backward.

Replaces the TPU kernels `deform_conv3d_fused` -> `_fused_call` and
`deform_conv3d_fused_bwd` -> `_fused_bwd_call` in
`dualpixelface_tpu/ops/kernels/deform_fused.py`. On the TPU the sampling
had to be one-hot matmuls over a +-3 voxel window; on the card it is a
gather (`csrc/deform_conv3d.cu`) and the backward a gather/scatter
(`csrc/deform_conv3d_bwd.cu`; source notes there), so one kernel pair
serves both semantics through `aperture`:

  * aperture=True: H/W sampling positions clamped to
    [out - AP, out + AP + 1 - EPS] (`clamp_positions`), the TPU kernel's
    windowed semantics (`deform_impl='pallas'`);
  * aperture=False: unbounded, the reference's sampling (`packed8`).

Each kernel takes one of two routes by dtype (`fwd_route`, `bwd_route`),
both on the tensor cores. bf16 (serving and the bf16 train path) runs bf16
`wgmma`, with x and the weight first laid out for it (`pack_deform_fwd`,
`pack_deform_bwd`: x's channels padded to CP, the weight as each tap's
rows). f32 (every committed run config trains in f32) runs split-TF32
(3xTF32, `split_f32.py`), which keeps IEEE f32's accuracy, on the same
padded x with the weight split into two TF32 planes: K1's as each tap's
plane [Co, CP] with K contiguous (`pack_deform_fwd_3xtf32`: TF32 `wgmma`
has no transpose flags), K2's as its rows (`pack_deform_bwd_3xtf32`).

The kernels take any Cin and any Co, as the TPU kernels do. The ANM's
widths at the committed `inplanes` (Cin 35 and 64, Co 64) keep the kernels'
tuned forms (x padded to CP 40 or 64); every other width takes their wide
forms (`layout`): x padded to a whole number of 64-channel chunks, walked
as more K steps (K1) or by blocks of their own (K2) into the same f32
sums, and Co padded with zero columns to whole 64-wide N tiles, each a
block of its own (K1's output and K2's gw sliced back to Co).
`deform_conv3d_fused` is differentiable: its backward recomputes from the
saved inputs, as the JAX custom VJP does, through `deform_conv3d_bwd`.
Each wrapper takes the plain PyTorch version for tensors on the CPU and the
kernel for CUDA tensors; anything else raises, as does a CUDA call with a
bias that is not [Co] or a volume past the kernels' 32-bit indexing.
Each launch counts on the tracer's `launch.K1` or `launch.K2` counter.
"""
from __future__ import annotations

import ctypes
import math

import torch

from dualpixelface_tpu_torch.ops.kernels import _build, split_f32
from dualpixelface_tpu_torch.utils.profiling import count

AP = 3               # aperture: +-AP voxels around the output voxel (H, W)
EPS = 1.0 / 1024.0
KTAPS = 27
CO = 64              # the tuned forms' output channels, and the wide forms' N tile
CIN_TUNED = 64       # the tuned forms take up to 64 input channels (at Co = CO)
CP_WIDTHS = (40, 64)  # the tuned forms: x's channels padded to the first that holds them
CHUNK = 64           # the wide forms: x's channels padded to a multiple of this, Co to one of CO
K_STEP = 16          # K1's wgmma contracts 16 channels a step: its weight rows per tap are CP rounded up
BWD_TILE = {torch.bfloat16: 128, torch.float32: 64}  # K2's voxels per tile, by dtype


def clamp_positions(pos: torch.Tensor, out_coord: torch.Tensor) -> torch.Tensor:
    """The aperture clamp, in f32: pos in [out - AP, out + AP + 1 - EPS]."""
    return torch.minimum(torch.maximum(pos, out_coord - AP), out_coord + AP + 1 - EPS)


def sample_cols(x: torch.Tensor, pos_d: torch.Tensor, pos_h: torch.Tensor, pos_w: torch.Tensor) -> torch.Tensor:
    """x [B, D, H, W, C] sampled trilinearly at f32 positions [B, N, K]
    (each axis's voxel units): cols [B, N, K, C] in f32, a corner outside
    the volume contributing zero, the 8 corners summed in f32 in corner
    order (cz, cy, cx)."""
    b, d, h, w, c = x.shape
    n, k = pos_d.shape[1:]
    dev, f32 = x.device, torch.float32
    d0, h0, w0 = torch.floor(pos_d), torch.floor(pos_h), torch.floor(pos_w)
    fd, fh, fw = pos_d - d0, pos_h - h0, pos_w - w0
    # gathered from an f32 copy: the same values, and in bf16 the backward
    # then accumulates x's gradient in f32 and rounds it once
    x_flat = x.reshape(b * d * h * w, c).float()
    batch_base = (torch.arange(b, device=dev) * (d * h * w)).reshape(b, 1, 1)
    cols = torch.zeros((b, n, k, c), dtype=f32, device=dev)
    for cz in (0, 1):
        zi, wz = d0 + cz, (fd if cz else 1.0 - fd)
        for cy in (0, 1):
            yi, wy = h0 + cy, (fh if cy else 1.0 - fh)
            for cx in (0, 1):
                xi, wx = w0 + cx, (fw if cx else 1.0 - fw)
                ok = (zi >= 0) & (zi <= d - 1) & (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
                wgt = torch.where(ok, wz * wy * wx, torch.zeros((), dtype=f32, device=dev))
                lin = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
                idx = (lin.long() + batch_base).reshape(-1)
                cols += wgt[..., None] * x_flat.index_select(0, idx).reshape(b, n, k, c)
    return cols


def deform_conv3d_plain(x, offset, weight, bias=None, aperture=False):
    """x [B, D, H, W, C], offset [B, D, H, W, 81] (tap k = (kd*3+kh)*3+kw,
    channels k*3 + (dD, dH, dW)), weight [3, 3, 3, C, Co] -> [B, D, H, W, Co].

    Positions are base + offset in f32; trilinear samples with zero-valued
    corners outside the volume, summed in f32 and rounded to x's dtype; one
    f32 product against the weight, rounded to x's dtype; the bias is then
    added in that dtype."""
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    dev = x.device
    f32 = torch.float32
    zz, yy, xx = torch.meshgrid(
        torch.arange(d, device=dev), torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    kz, ky, kx = torch.meshgrid(*(torch.arange(3, device=dev),) * 3, indexing="ij")
    base_d = (zz.reshape(-1, 1) - 1 + kz.reshape(1, -1)).to(f32)  # [N, 27]
    base_h = (yy.reshape(-1, 1) - 1 + ky.reshape(1, -1)).to(f32)
    base_w = (xx.reshape(-1, 1) - 1 + kx.reshape(1, -1)).to(f32)
    n = d * h * w
    off = offset.reshape(b, n, KTAPS, 3).to(f32)
    pos_d = base_d + off[..., 0]  # [B, N, 27]
    pos_h = base_h + off[..., 1]
    pos_w = base_w + off[..., 2]
    if aperture:
        pos_h = clamp_positions(pos_h, yy.reshape(1, -1, 1).to(f32))
        pos_w = clamp_positions(pos_w, xx.reshape(1, -1, 1).to(f32))
    cols = sample_cols(x, pos_d, pos_h, pos_w).to(x.dtype).reshape(b * n, KTAPS * c)
    out = (cols.float() @ weight.reshape(KTAPS * c, co).float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.reshape(b, d, h, w, co)


def deform_conv3d_bwd_plain(x, offset, weight, bias, g, aperture=False):
    """(gx, goff, gw, gb) of `deform_conv3d_plain` for the cotangent g,
    by autograd through it: floor-based corners (derivative -1 / +1 at an
    integer position), zero from corners outside the volume, and the
    aperture clamp's 0.5 at a bound, as the TPU kernel's `_hat_grad` and
    `jnp.clip` give them. gb is None without a bias."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, offset, weight)]
        if bias is not None:
            leaves.append(bias.detach().requires_grad_(True))
        out = deform_conv3d_plain(*leaves[:3], leaves[3] if bias is not None else None, aperture)
        grads = torch.autograd.grad(out, leaves, g)
    return tuple(grads) + ((None,) if bias is None else ())


def fwd_route(dtype: torch.dtype) -> str:
    """K1's kernel for a dtype: "tensor_cores" (bf16: the `wgmma`
    contraction, serving and the bf16 train path's forward) or
    "tensor_cores_3xtf32" (f32, the committed run configs and the f32
    Predictor: the same contraction in split-TF32, f32-accurate). Both take
    either aperture."""
    return split_f32.route("deform_conv3d_fused", dtype)


def bwd_route(dtype: torch.dtype) -> str:
    """K2's kernel for a dtype: "tensor_cores" (bf16: `wgmma` contractions,
    the bf16 train path) or "tensor_cores_3xtf32" (f32, the committed run
    configs: the same contractions in split-TF32, f32-accurate). Both take
    either aperture."""
    return split_f32.route("deform_conv3d_bwd", dtype)


def layout(c: int, co: int = CO) -> tuple[bool, int, int]:
    """The kernels' form for Cin = c and Co = co: (wide, CP, COP). The
    tuned form (c <= CIN_TUNED and co == CO) reads x padded to CP, the
    first of CP_WIDTHS >= c; the wide form x padded to CP, c rounded up to
    a whole number of CHUNK-channel chunks, and its output (K1) or
    cotangent (K2) padded to COP, co rounded up to whole N tiles of CO."""
    if c <= CIN_TUNED and co == CO:
        return False, next(w for w in CP_WIDTHS if w >= c), CO
    return True, -(-c // CHUNK) * CHUNK, -(-co // CO) * CO


def bwd_plan(shape, dtype: torch.dtype, sms: int, co: int = CO) -> tuple[str, int, int]:
    """K2's launch for x of `shape` [B, D, H, W, C] and `dtype` on a card of
    `sms` SMs: its route, the channels it reads x with (C padded to CP) and
    the number of per-block gw partial sums (blocks per tap and, in the wide
    form, per chunk and N tile, each owning a share of the voxel tiles, 128
    voxels in bf16 and 64 in f32: about eight blocks per SM in all, four
    waves of two blocks an SM in bf16, eight waves of one or four of two in
    f32)."""
    route = bwd_route(dtype)
    c, m = shape[-1], math.prod(shape[:-1])
    return route, layout(c, co)[1], max(1, min(-(-m // BWD_TILE[dtype]), round(8 * sms / KTAPS)))


def _pack(x: torch.Tensor, weight: torch.Tensor, rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, D, H, W, C] with zero channels appended up to CP (`layout`;
    itself when C is CP), and weight [3, 3, 3, C, Co] as the taps' rows
    [27, rows, COP] (rows CP unless given), zero past C and Co."""
    c, co = x.shape[-1], weight.shape[-1]
    _, cp, cop = layout(c, co)
    if cp != c:
        x = torch.nn.functional.pad(x, (0, cp - c))
    rows = cp if rows is None else rows
    wpk = weight.reshape(KTAPS, c, co)
    if (rows, cop) != (c, co):
        wpk = torch.nn.functional.pad(wpk, (0, cop - co, 0, rows - c))
    return x, wpk.contiguous()


def pack_deform_bwd(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's tensor-core operands: x padded to CP channels and the taps'
    weight rows [27, CP, COP] (each tap's rows are the B of its gcols
    product)."""
    return _pack(x, weight)


def pack_deform_bwd_3xtf32(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's f32 operands: `pack_deform_bwd`'s, the weight rows split into
    their two TF32 planes [2, 27, CP, COP] (hi, lo; `split_f32.split_planes`)."""
    xp, wpk = pack_deform_bwd(x, weight)
    return xp, split_f32.split_planes(wpk)


def fwd_weight_rows(c: int, co: int = CO) -> int:
    """K1's weight rows per tap for C input channels: CP rounded up to the
    wgmma K step (40 -> 48, 64 -> 64; the wide form's CP as it is)."""
    return -(-layout(c, co)[1] // K_STEP) * K_STEP


def pack_deform_fwd(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's tensor-core operands: x padded to CP channels and the taps'
    weight rows [27, KP, COP], KP = `fwd_weight_rows(C, Co)` (each tap's rows
    are the B of its product; the rows past CP meet the A tile's zero
    channels)."""
    return _pack(x, weight, fwd_weight_rows(x.shape[-1], weight.shape[-1]))


def pack_deform_fwd_3xtf32(x: torch.Tensor, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's f32 operands: x padded to CP channels, and each tap's weight
    plane [COP, CP] (the tap's rows transposed: K contiguous, as TF32
    `wgmma` reads B; zero past C and Co) split into its two TF32 planes
    [2, 27, COP, CP] (hi, lo; `split_f32.split_planes`). CP is a whole
    number of the TF32 K step of 8, so no rows are added."""
    xp, wpk = pack_deform_bwd(x, weight)
    return xp, split_f32.split_planes(wpk.transpose(1, 2))


def _check_inputs(name, x, offset, weight):
    if x.ndim != 5 or offset.shape != x.shape[:4] + (3 * KTAPS,) or weight.shape[:4] != (3, 3, 3, x.shape[-1]):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, offset {tuple(offset.shape)}, weight "
            f"{tuple(weight.shape)} must be [B, D, H, W, C], [B, D, H, W, 81], [3, 3, 3, C, Co]"
        )
    _build.check_device(name, x.device)


def _check_cuda_call(name, x, offset, weight, bias, **more):
    """What the CUDA kernels take: a bias of [Co], one dtype, 32-bit indexing."""
    co = weight.shape[-1]
    if bias is not None and bias.shape != weight.shape[-1:]:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} must be [{co}]")
    _build.check_cuda_tensors(name, x.device, x=x, offset=offset, weight=weight, bias=bias, **more)
    b, d, h, w, c = x.shape
    _, cp, cop = layout(c, co)
    if b * d * h * w * max(cp, cop, 3 * KTAPS) >= 2**31 or KTAPS * cp * cop >= 2**31:
        raise ValueError(f"{name}: tensor too large for the kernel's 32-bit indexing")


def _forward(x, offset, weight, bias, aperture):
    if x.device.type == "cpu":
        return deform_conv3d_plain(x, offset, weight, bias, aperture)
    _check_cuda_call("deform_conv3d_fused", x, offset, weight, bias)
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    wide, cp, cop = layout(c, co)
    bf16 = fwd_route(x.dtype) == "tensor_cores"
    xp, wpk = pack_deform_fwd(x, weight) if bf16 else pack_deform_fwd_3xtf32(x, weight)
    out = torch.empty((b, d, h, w, cop), dtype=x.dtype, device=x.device)
    if wide:
        if bias is not None and cop != co:
            bias = torch.nn.functional.pad(bias, (0, cop - co))
        fn = _build.entry("deform_conv3d", "dpf_deform_conv3d_wide",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        rc = fn(xp.data_ptr(), offset.data_ptr(), wpk.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), b, d, h, w, c, cp, cop, int(bool(aperture)), int(bf16),
                _build.current_stream(x.device))
    else:
        symbol = "dpf_deform_conv3d_tc" if bf16 else "dpf_deform_conv3d_3xtf32"
        fn = _build.entry("deform_conv3d", symbol, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        rc = fn(xp.data_ptr(), offset.data_ptr(), wpk.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), b, d, h, w, c, cp, CO, int(bool(aperture)), _build.current_stream(x.device))
    count("launch.K1")
    _build.check_launch(rc, "deform_conv3d_fused")
    return out if cop == co else out[..., :co].contiguous()


class _DeformConv3d(torch.autograd.Function):
    """K1 forward; the backward recomputes from (x, offset, weight, bias)."""

    @staticmethod
    def forward(ctx, x, offset, weight, bias, aperture):
        ctx.save_for_backward(x, offset, weight, bias)
        ctx.aperture = aperture
        return _forward(x, offset, weight, bias, aperture)

    @staticmethod
    def backward(ctx, g):
        x, offset, weight, bias = ctx.saved_tensors
        gx, goff, gw, gb = deform_conv3d_bwd(x, offset, weight, bias, g.contiguous(), ctx.aperture)
        return gx, goff, gw, gb, None


def deform_conv3d_fused(x, offset, weight, bias=None, aperture=True):
    """Deformable 3x3x3 conv, stride 1, pad 1, differentiable. CPU tensors:
    the plain version. CUDA tensors: the K1 kernel (K2 for the backward),
    or an error."""
    _check_inputs("deform_conv3d_fused", x, offset, weight)
    return _DeformConv3d.apply(x, offset, weight, bias, bool(aperture))


def deform_conv3d_bwd(x, offset, weight, bias, g, aperture=True):
    """(gx, goff, gw, gb) of `deform_conv3d_fused` for the cotangent g
    [B, D, H, W, Co], each in its input's dtype (gb None without a bias).
    CPU tensors: `deform_conv3d_bwd_plain`. CUDA tensors: the K2 kernel of
    the dtype's route (`bwd_route`: bf16 `wgmma`, or 3xTF32 `wgmma` for
    f32), or an error."""
    _check_inputs("deform_conv3d_bwd", x, offset, weight)
    if g.shape != x.shape[:4] + weight.shape[-1:]:
        raise ValueError(f"deform_conv3d_bwd: g {tuple(g.shape)} must be {tuple(x.shape[:4] + weight.shape[-1:])}")
    if x.device.type == "cpu":
        return deform_conv3d_bwd_plain(x, offset, weight, bias, g, aperture)
    _check_cuda_call("deform_conv3d_bwd", x, offset, weight, bias, g=g)
    b, d, h, w, c = x.shape
    co = weight.shape[-1]
    dev, f32 = x.device, torch.float32
    wide, cp, cop = layout(c, co)
    route, _, nsplit = bwd_plan(x.shape, x.dtype, torch.cuda.get_device_properties(dev).multi_processor_count, co)
    bf16 = route == "tensor_cores"
    xp, wpk = pack_deform_bwd(x, weight) if bf16 else pack_deform_bwd_3xtf32(x, weight)
    goff = torch.empty_like(offset)
    gw = torch.empty_like(weight)
    gwp = torch.empty((nsplit, KTAPS * c, cop), dtype=f32, device=dev)
    gx32 = torch.empty((b, d, h, w, cp), dtype=f32, device=dev)
    gx = gx32 if (x.dtype, c) == (f32, cp) else torch.empty_like(x)  # f32 at C = CP: the sum is the gradient
    if wide:
        gp = g if cop == co else torch.nn.functional.pad(g, (0, cop - co))
        nch = cp // CHUNK
        goffp = torch.empty((nch, b, d, h, w, 3 * KTAPS), dtype=f32, device=dev) if nch > 1 else None
        fn = _build.entry("deform_conv3d_bwd", "dpf_deform_conv3d_bwd_wide",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        rc = fn(xp.data_ptr(), offset.data_ptr(), wpk.data_ptr(), gp.data_ptr(), gx32.data_ptr(), gx.data_ptr(),
                goff.data_ptr(), gwp.data_ptr(), gw.data_ptr(), None if goffp is None else goffp.data_ptr(),
                b, d, h, w, c, cp, co, cop, nsplit, int(bool(aperture)), int(bf16), _build.current_stream(dev))
    else:
        symbol = "dpf_deform_conv3d_bwd_tc" if bf16 else "dpf_deform_conv3d_bwd_3xtf32"
        fn = _build.entry("deform_conv3d_bwd", symbol, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        rc = fn(xp.data_ptr(), offset.data_ptr(), wpk.data_ptr(), g.data_ptr(), gx32.data_ptr(), gx.data_ptr(),
                goff.data_ptr(), gwp.data_ptr(), gw.data_ptr(), b, d, h, w, c, cp, CO, nsplit, int(bool(aperture)),
                _build.current_stream(dev))
    count("launch.K2")
    _build.check_launch(rc, "deform_conv3d_bwd")
    gb = None if bias is None else g.sum(dim=(0, 1, 2, 3), dtype=f32).to(bias.dtype)
    return gx, goff, gw, gb
