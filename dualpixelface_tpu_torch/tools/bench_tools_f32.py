"""T1 and T4, the tools' kernels, on their f32 routes, on the card: in
this checkout or in another one, so that two trees can be timed in turns
in one call.

    python3 -m dualpixelface_tpu_torch.tools.bench_tools_f32 [--root DIR]

T1 (`conv3d_dslice_v2`) in f32 at the four sites of `bench_dslice_fold`
(batch 4 at 768x576, folded BatchNorm and ReLU) through that tool's
`measure` (beside the f32 ConvBN3D + ReLU chain and cuDNN's conv) and
`check`, and T4 (`batched_dot`) at `bench_vpu_prims`' f32 run through its
`measure` (beside `torch.bmm`), each also on the device alone
(`tools.device_ms`), with TF32 off for cuDNN and CUDA matmuls (exact f32).
One JSON line per site and for T4, then their sums, after the card's name
and power limit. With `--root DIR` it runs as a file under DIR's package
instead (e.g. `git archive HEAD` unpacked into `build/parent`), and so
times DIR's kernels: it uses only what those tools have had since T1 and
T4 were ported. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from dualpixelface_tpu_torch.ops.kernels import prims
from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice_v2 import conv3d_dslice_v2
from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold
from dualpixelface_tpu_torch.tools import bench_vpu_prims as vpu
from dualpixelface_tpu_torch.tools import device_ms, require_cuda

SEED = 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="time the kernels of the checkout at DIR instead")
    args = ap.parse_args()
    if args.root is not None:
        root = str(Path(args.root).resolve())
        env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        return subprocess.run([sys.executable, str(Path(__file__).resolve())], cwd=root, env=env).returncode
    require_cuda("bench_tools_f32")
    from dualpixelface_tpu_torch.profile_serving import _card

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    checkout = str(Path(fold.__file__).resolve().parents[2])
    print(json.dumps({"card": _card(), "checkout": checkout}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    keys = ("t1_ms", "device_ms", "chain_ms", "cudnn_conv_ms", "flops", "bytes")
    sums = dict.fromkeys(keys, 0.0)
    for label, shape, co in fold.SITES:
        inp = fold.site_inputs(shape, co, gen, torch.float32)
        m = fold.measure(label, inp)
        m["device_ms"] = device_ms(lambda: conv3d_dslice_v2(inp["x"], inp["wmat"], inp["ab"], relu=True), 10)
        m["checks"] = fold.check(inp)
        for k in keys:
            sums[k] += m[k]
        print(json.dumps({"checkout": checkout, **{k: v for k, v in m.items() if k != "readings_ms"}}), flush=True)
        del inp
        torch.cuda.empty_cache()
    run = vpu.Run("dot", torch.float32, m=128)
    inputs = run.inputs(gen)
    m = vpu.measure(run, inputs)
    m["device_ms"] = device_ms(lambda: prims.batched_dot(*inputs), 10)
    m["max_abs_err"] = float((prims.batched_dot(*inputs) - prims.batched_dot_plain(*inputs)).abs().max())
    print(json.dumps({"checkout": checkout, **m}), flush=True)
    print(json.dumps({"checkout": checkout, "T1_f32_sum": sums,
                      "T4_f32": {k: m[k] for k in ("ms", "device_ms", "library_ms")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
