"""A/B of the epilogue-fused 3x3x3 conv (T1, `conv3d_dslice_v2`) against
the port's eval ConvBN3D + ReLU chain, on the card: the counterpart of
`tools/bench_dslice_fold.py --module convbn` with the attic kernel in it.

    python3 -m dualpixelface_tpu_torch.tools.bench_dslice_fold [--site dres]

At each stride-1 site of the JAX tool's `SITES` that T1 serves (the Co-81
offset heads are K5's), batch 4 at 768x576, in bf16 and then in f32 (T1's
3xTF32 route; cuDNN with TF32 off, so in exact f32), seeded weights and
BatchNorm statistics, it times with CUDA events over ITERS launches
after one warm-up launch, in turns (T1, chain, conv NCDHW, conv
channels_last_3d, and back):

  * T1 with the eval BatchNorm folded into `ab` and relu=True, on NDHWC
    input;
  * `blocks.ConvBN3D` (cuDNN conv + BatchNorm) + ReLU, on NCDHW input;
  * cuDNN's conv alone, the yardstick (`tools.cudnn_conv3d_calls`), on
    NCDHW input and on channels_last_3d input (T1's NDHWC memory); the
    faster is `cudnn_conv_ms`;

and checks T1 against its plain version without and with the folded
BatchNorm and ReLU (`check`). Each time stands beside the bound of the
dtype's route (`bound_ms`: bf16 at the bf16 tensor-core peak, f32 with
every operation on the CUDA cores) and, in f32, the split bound
(`split_bound_ms`: the product three times over as TF32 on the tensor
cores). One JSON line per site and dtype, after the card's name and power
limit. No model path calls T1: the BatchNorm fold lives here, as in the
JAX package. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from dualpixelface_tpu_torch.ops.blocks import ConvBN3D
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import conv3d_dslice_v2, conv3d_dslice_v2_plain, route
from dualpixelface_tpu_torch.tools import (
    PEAK_BF16, PEAK_F32, PEAK_TF32, bound_ms, cuda_ms, cudnn_conv3d_calls, require_cuda)

ITERS = 10
SEED = 0

# label, input [B, D, H, W, Cin], Co: the stride-1 hourglass sites at 768x576, batch 4
SITES = (
    ("dres0_0 64->32", (4, 8, 192, 144, 64), 32),
    ("dres* 32->32", (4, 8, 192, 144, 32), 32),
    ("hg conv2 64->64", (4, 4, 96, 72, 64), 64),
    ("hg conv4 64->64", (4, 2, 48, 36, 64), 64),
)


def fold_bn(bn: torch.nn.BatchNorm3d) -> torch.Tensor:
    """The eval BatchNorm as the affine [a; b] ([2, C] f32):
    a = w * rsqrt(var + eps), b = beta - mean * a."""
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return torch.stack([a, bn.bias.float() - bn.running_mean.float() * a]).contiguous()


def site_inputs(shape, co: int, gen: torch.Generator, dtype=torch.bfloat16) -> dict:
    """A seeded eval ConvBN3D (random BatchNorm statistics) on the card in
    `dtype`, its input in both layouts, and T1's arguments."""
    cin = shape[-1]
    dev = gen.device
    module = ConvBN3D(cin, co).to(dev).eval()
    conv, bn = module[0], module[1]
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device=dev) / math.sqrt(27 * cin))
        bn.weight.copy_(torch.rand(co, generator=gen, device=dev) + 0.5)
        bn.bias.copy_(torch.randn(co, generator=gen, device=dev) * 0.5)
        bn.running_mean.copy_(torch.randn(co, generator=gen, device=dev) * 0.5)
        bn.running_var.copy_(torch.rand(co, generator=gen, device=dev) + 0.5)
    module = module.to(dtype).requires_grad_(False)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return {"module": module, "x": x, "x_cf": x.permute(0, 4, 1, 2, 3).contiguous(),
            "wmat": conv.weight.permute(2, 3, 4, 1, 0).contiguous(), "ab": fold_bn(bn)}


def work(inp: dict) -> dict:
    """The conv's FLOP and the bytes T1 must move (x, wmat, ab read once,
    the output written once)."""
    b, d, h, w, c = inp["x"].shape
    co = inp["wmat"].shape[-1]
    m = b * d * h * w
    nbytes = sum(t.numel() * t.element_size() for t in (inp["x"], inp["wmat"], inp["ab"]))
    return {"flops": 2.0 * m * 27 * c * co, "bytes": nbytes + m * co * inp["x"].element_size()}


def measure(label: str, inp: dict) -> dict:
    """T1, the ConvBN3D + ReLU chain and cuDNN's conv, timed in turns; the
    conv in NCDHW (the chain's layout) and in channels_last_3d (x's NDHWC
    memory, T1's layout), `cudnn_conv_ms` the faster of the two."""
    x, x_cf, wmat, ab, module = inp["x"], inp["x_cf"], inp["wmat"], inp["ab"], inp["module"]
    fns = {
        "t1": lambda: conv3d_dslice_v2(x, wmat, ab, relu=True),
        "chain": lambda: torch.relu(module(x_cf)),
        **{f"cudnn_{layout}": call for layout, call in cudnn_conv3d_calls(x, wmat).items()},
    }
    times = {k: [] for k in fns}
    for k in ("t1", "chain", "cudnn_ncdhw", "cudnn_channels_last_3d", "cudnn_channels_last_3d", "cudnn_ncdhw",
              "chain", "t1"):
        times[k].append(cuda_ms(fns[k], ITERS))
    w = work(inp)
    f32 = x.dtype == torch.float32
    b_ms, b_by = bound_ms(w["bytes"], (w["flops"], PEAK_F32 if f32 else PEAK_BF16))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    layout = min(("ncdhw", "channels_last_3d"), key=lambda k: ms[f"cudnn_{k}"])
    res = {"site": label, "shape": list(x.shape), "co": wmat.shape[-1], "dtype": str(x.dtype),
           "route": route(x.dtype), "t1_ms": ms["t1"], "chain_ms": ms["chain"], "cudnn_conv_ms": ms[f"cudnn_{layout}"],
           "cudnn_layout": layout, "cudnn_ncdhw_ms": ms["cudnn_ncdhw"],
           "cudnn_channels_last_3d_ms": ms["cudnn_channels_last_3d"], "t1_over_chain": ms["t1"] / ms["chain"],
           "t1_tflops": w["flops"] / ms["t1"] / 1e9, "readings_ms": times, "bound_ms": b_ms, "bound_by": b_by,
           "flops": w["flops"], "bytes": w["bytes"]}
    if f32:  # the route's product, three times over as TF32
        res["split_bound_ms"], res["split_bound_by"] = bound_ms(w["bytes"], (3 * w["flops"], PEAK_TF32))
    return res


def check(inp: dict) -> list[dict]:
    """T1 against its plain version on `inp`, without and then with the
    folded BatchNorm and ReLU: for each, its largest error and the largest
    ratio of an output's error to its allowance (`excess_error`)."""
    res = []
    for ab, relu in ((None, False), (inp["ab"], True)):
        got = conv3d_dslice_v2(inp["x"], inp["wmat"], ab, relu=relu).float()
        ref = conv3d_dslice_v2_plain(inp["x"], inp["wmat"], ab, relu=relu).float()
        res.append({"ab": ab is not None, "relu": relu, **excess_error(got, ref, inp["x"].dtype)})
        del got, ref
    return res


def excess_error(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> dict:
    """max |got - ref| and the largest ratio of an output's error to its
    allowance: 1e-4 of max(1, max |ref|) (f32 sums in another order), plus,
    in bf16, one ulp of the output (both round one f32 value once)."""
    err = (got - ref).abs()
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    if dtype == torch.bfloat16:
        mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return {"max_abs_err": float(err.max()), "worst_ratio": float((err / tol).max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--site", default=None, help="comma-separated substring filter on site labels")
    args = ap.parse_args()
    require_cuda("bench_dslice_fold")
    from dualpixelface_tpu_torch.profile_serving import _card

    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": _card()}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wanted = args.site.split(",") if args.site else None
    for label, shape, co in SITES:
        if wanted and not any(s in label for s in wanted):
            continue
        for dtype in (torch.bfloat16, torch.float32):
            inp = site_inputs(shape, co, gen, dtype)
            res = {**measure(label, inp), "checks": check(inp)}
            print(json.dumps(res), flush=True)
            if any(c["worst_ratio"] > 1.0 for c in res["checks"]):
                raise SystemExit(f"{label} {dtype}: T1 disagrees with its plain version")
            del inp
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
