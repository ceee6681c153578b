"""The rates of the primitives the fused deform kernel is built from, on
the card: the counterpart of `tools/bench_vpu_prims.py`.

    python3 -m dualpixelface_tpu_torch.tools.bench_vpu_prims

The same eight runs at the same shapes and G = 4096 as the JAX tool:

  * T2 `lane_gather_sum`: a gather along 128-wide rows, 8 index rows per
    g, at (rows 320, f32), (320, bf16), (160, f32);
  * T3 `transpose_sum`: 8 slabs [128, 80] -> [80, 128] per g, f32 and bf16;
  * T4 `batched_dot`: [m, 2240] x [2240, 64] per g with f32 sums, at m 128
    in f32 and bf16 and m 32 in bf16.

Inputs come from a seeded `torch.Generator` on the card. Each run is timed
with CUDA events over ITERS launches after one warm-up launch and printed
as one JSON line in the JAX tool's terms (ms, G elem/s or TFLOP/s) with
its bound and, for T4, the time of `torch.bmm` on the same inputs (which
the port never calls; in bf16 it rounds its output to bf16; in f32 it runs
with TF32 off, in exact f32). T4's f32 run also gives its split bound
(`split_bound_ms`: its route's products three times over as TF32 on the
tensor cores; `bound_ms` puts them on the CUDA cores). The card's name and
power limit come first. Needs a GPU.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import torch

from dualpixelface_tpu_torch.ops.kernels import prims
from dualpixelface_tpu_torch.tools import PEAK_BF16, PEAK_F32, PEAK_TF32, bound_ms, cuda_ms, require_cuda

GRID = 4096
ITERS = 10
SEED = 0
REPS = prims.REPS
DOT_K, DOT_N = 2240, prims.DOT_N


@dataclass(frozen=True)
class Run:
    """One run of the tool: a primitive ("gather", "transpose", "dot") at
    a dtype and, for the gather, its rows, for the dot its m."""

    kind: str
    dtype: torch.dtype
    rows: int = 0
    m: int = 0

    @property
    def kernel_id(self) -> str:
        return {"gather": "T2", "transpose": "T3", "dot": "T4"}[self.kind]

    @property
    def label(self) -> str:
        dt = str(self.dtype).removeprefix("torch.")
        if self.kind == "gather":
            return f"gather {dt}[{self.rows},128] x{REPS}"
        if self.kind == "transpose":
            return f"transpose {dt}[128,80]->[80,128] x{REPS}"
        return f"dot {dt} [{self.m},{DOT_K}]x[{DOT_K},{DOT_N}]"

    def inputs(self, gen: torch.Generator) -> tuple:
        dev, g = gen.device, GRID
        if self.kind == "gather":
            tab = torch.randn((g, self.rows, prims.LANES), generator=gen, device=dev).to(self.dtype)
            idx = torch.randint(0, prims.LANES, (g, REPS, prims.LANES), generator=gen, device=dev)
            return tab, idx.to(prims.INDEX_DTYPE[self.dtype])
        if self.kind == "transpose":
            return (torch.randn((g, REPS, prims.LANES, prims.SLAB_C), generator=gen, device=dev).to(self.dtype),)
        a = torch.randn((g, self.m, DOT_K), generator=gen, device=dev).to(self.dtype)
        return a, torch.randn((g, DOT_K, DOT_N), generator=gen, device=dev).to(self.dtype)

    @property
    def kernel(self):
        return {"gather": prims.lane_gather_sum, "transpose": prims.transpose_sum, "dot": prims.batched_dot}[self.kind]

    @property
    def plain(self):
        return {"gather": prims.lane_gather_sum_plain, "transpose": prims.transpose_sum_plain,
                "dot": prims.batched_dot_plain}[self.kind]

    def work(self, inputs: tuple) -> dict:
        """The operations the function needs and their peak rate, the bytes
        it must move (inputs read once, output written once), and the
        elements or FLOP of the JAX tool's rate."""
        g = inputs[0].shape[0]
        if self.kind == "gather":
            out_bytes = inputs[0].numel() * inputs[0].element_size()
        elif self.kind == "transpose":
            out_bytes = g * prims.SLAB_C * prims.LANES * inputs[0].element_size()
        else:
            out_bytes = g * self.m * DOT_N * 4  # f32
        nbytes = sum(t.numel() * t.element_size() for t in inputs) + out_bytes
        if self.kind == "dot":
            flops = 2.0 * g * self.m * DOT_K * DOT_N
            return {"ops": flops, "peak": PEAK_F32 if self.dtype == torch.float32 else PEAK_BF16,
                    "bytes": nbytes, "rate_units": flops, "rate_name": "TFLOP/s", "rate_scale": 1e12}
        # one add per value gathered or transposed, on the CUDA cores
        elems = float(inputs[0].numel()) * (REPS if self.kind == "gather" else 1)
        return {"ops": elems, "peak": PEAK_F32, "bytes": nbytes,
                "rate_units": elems, "rate_name": "G elem/s", "rate_scale": 1e9}


RUNS = (
    Run("gather", torch.float32, rows=320),
    Run("gather", torch.bfloat16, rows=320),
    Run("gather", torch.float32, rows=160),
    Run("transpose", torch.float32),
    Run("transpose", torch.bfloat16),
    Run("dot", torch.float32, m=128),
    Run("dot", torch.bfloat16, m=128),
    Run("dot", torch.bfloat16, m=32),
)


def measure(run: Run, inputs: tuple) -> dict:
    """Time `run`'s kernel on `inputs` (and, for T4, `torch.bmm`) and put
    the time beside the bound."""
    ms = cuda_ms(lambda: run.kernel(*inputs), ITERS)
    w = run.work(inputs)
    b_ms, b_by = bound_ms(w["bytes"], (w["ops"], w["peak"]))
    lib = cuda_ms(lambda: torch.bmm(*inputs), ITERS) if run.kind == "dot" else None
    res = {"run": run.label, "kernel": run.kernel_id, "ms": ms,
           w["rate_name"]: w["rate_units"] / (ms * 1e-3) / w["rate_scale"], "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "bytes": w["bytes"], "ops": w["ops"]}
    if run.kind == "dot" and run.dtype == torch.float32:  # the route's products, three times over as TF32
        res["split_bound_ms"], res["split_bound_by"] = bound_ms(w["bytes"], (3 * w["ops"], PEAK_TF32))
    return res


def main() -> int:
    require_cuda("bench_vpu_prims")
    from dualpixelface_tpu_torch.profile_serving import _card

    torch.backends.cuda.matmul.allow_tf32 = False  # torch.bmm's f32 product in full f32
    print(json.dumps({"card": _card(), "grid": GRID}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for run in RUNS:
        inputs = run.inputs(gen)
        print(json.dumps(measure(run, inputs)), flush=True)
        del inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
