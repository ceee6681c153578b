#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the nine CUDA kernels from `dualpixelface_tpu_torch/csrc/`
     (one nvcc per source, all at once), print the build seconds and each
     entry function's registers, shared memory and spill bytes from the
     build log; a tensor-core kernel (the bf16 routes of K1, of K5 and T1,
     of K2 and of T4, the 3xTF32 f32 routes of K5 and T1, of K2, of K1 and
     of T4, and K1's and K2's wide forms, the `<64, true>` instantiations of
     both routes) or an instantiation of K3 or K4 (each dtype, D = 1..16,
     and each dtype's wide form for D > 16) that spills, or one missing from
     the log, fails;
  3. check each forward kernel (K1, K5) against its plain PyTorch
     version on the same seeded CUDA tensors at the serving path's shapes,
     in bf16 and f32; each check names its route (K1 and K5: bf16 `wgmma`
     for bf16, 3xTF32 `wgmma` for f32); then K1 (both
     apertures) and K5 in f32 at a data-parallel rank's batch 2 (phase 11);
     then K1 and K5 in f32 at the trainer path's batch 4 (phase 10),
     checked and timed beside their plain versions (K5 also beside
     cuDNN's exact f32 conv3d): the f32 routes' yardstick; then K1 at every
     width of WIDTH_CINS x WIDTH_COS (Cin 3, 15, 51, 96, 131; Co 16, 24, 96,
     128) on the ANM's D = 4 and 192x144 plane, batch 1, both routes and
     apertures, and K5 at Cin 51 and 96;
  3b. the same for the backward kernels at the train path's shapes: K2 (all
     four gradients, both apertures, a quarter of the offsets whole numbers
     and some on the window bound; each check names its route, bf16
     `wgmma` for bf16 and 3xTF32 `wgmma` for f32), then K2's f32
     route at the trainer path's batch 4 (phase 10), against its plain
     version on two batch-2 halves, and timed there; K2 at every width of
     WIDTH_CINS x WIDTH_COS, as K1 in phase 3;
  3c. K1 (Cin 35 and 64, both apertures), K5 (Cin 35 and 64), T1 (Co 32
     and 64, without and with the folded BatchNorm and ReLU) and K2 (Cin 35
     and 64, both apertures) at small ragged shapes (`EDGE_SHAPES`: M no
     multiple of a tile, H or W below 3, D = 1), bf16 and f32, each check
     naming its route;
  3d. K3 at the serving batch and K4 at the train batch, at the paths'
     coarse shape for D = 8, 5 and 16 and at (50, 36) for every D = 1..16
     (each instantiation), and for D = 17, 24 and 64 (the wide forms) at
     both, then logits of scale 30 with a cell of planes near -200 and one
     whose bins all underflow below the max over its planes (D = 8 and
     24), f32 and bf16; K4 twice on the same inputs, bit for bit; then
     K4 in f32 at the trainer path's batch 4 (phase 10), D = 8, and K3 in
     f32 at a data-parallel rank's batch 2 (phase 11), D = 8;
  4. time each forward kernel, its plain version and, for K5, cuDNN's
     conv3d (which the port never calls) in NCDHW and in channels_last_3d
     (the kernel's own NDHWC), the faster of the two as its `library_ms`,
     with CUDA events and on the device alone (`tools.device_ms`); one
     `K1_run` and one `K5_run` line per Cin (K1's time includes its
     operands' packing);
  4b. the same for K2 at the train path's shapes;
  4c. K3 (serving shape) and K4 (train shape) in bf16, with CUDA events and
     on the device alone (`tools.device_ms`, the union of the device
     intervals: the host's dispatch left out), beside their plain versions;
  4d. each widened route at phase 14's shapes (`time_wide_routes`), both
     dtypes: K1 at the serving batch 4 and K2 at the train batch 2 (Cin 51
     and 96, Co 96), each first checked against its plain version on the
     same inputs within REL_TOL / BWD_TOL (K2's f32 plain version on the
     two halves of the batch), K3 [4, 24, 192, 144], K4 [2, 24, 192, 144]
     (checked at these shapes in 3d); ms, device ms, plain ms (the
     `wide_run` lines);
  5. serve 3 request batches of 4 dual-pixel pairs at 768x576 in bf16
     through `Predictor` (seeded weights, non-zero offset heads): shapes,
     finiteness, launch counts (K1 +2, K5 +2, K3 +1 per forward), and a
     smoke reading of pairs/s (the serving rate proper, over many batches,
     is `python3 -m dualpixelface_tpu_torch.profile_serving`'s);
  5b. the same for the reference-exact `stereodpnet` configuration (exact
     attention, unbounded deform, unfused regression): shapes with
     `prob_depth` [4, 1, 32, 768, 576], finiteness, launch counts (K1 +2,
     K5 +2, K3 +0 per forward: the regression is the plain soft-argmin, as
     in JAX), the peak memory and a smoke reading of pairs/s;
  5c. both serving configurations at 768x576, batch 4 (`stereodpnet_plus`
     in bf16, `stereodpnet` in f32, as the benchmark serves them), the
     front stages (feature tower, ASM, aggregation) replayed from CUDA
     graphs (`utils/graphs`), against the eager forward of the same
     weights: answers bit for bit (or within REL_TOL, each difference
     named), answers kept unchanged by later calls and sharing no graph
     buffer, `serve.graph_replays` +3 a call from the third call on,
     launches per forward K1 2, K3 1 (0 unfused), K5 2;
  6. the same weights at 192x192, batch 1, f32: the card's forward (kernels)
     against the CPU forward (plain versions);
  6b. the same for `stereodpnet`, with phase 6's tolerances;
  7. train 3 steps in the train cell (the run keys `profile_train.
     TRAIN_CELL`: batch 2 under the bf16 policy) at 768x576 through
     `make_train_step` (the same seeded weights, Adam): finite losses,
     every weight moved and still the optimizer's f32 master, launch
     counts per step (K1 2, K5 2, K3 3, K2 2, K4 3), the peak memory, and a
     smoke reading of pairs/s through `profile_serving.timed` (the rate
     proper is profile_train's);
  7b. the same for the JAX bench's own train cell (`profile_train.CELLS
     ["bench"]`: `stereodpnet`, exact attention, windowed deform without
     the offset clamp, fused regression), with the same launch counts per
     step and its peak memory (the exact attention's backward at full size,
     without recomputation);
  8. one f32 train step of batch 2 at 32x32 from the committed plateau
     checkpoint on the card against the same step on the CPU, at a point
     where both took the same side of every kink: losses and each
     parameter's gradient;
  9. the tools' kernels (`tools_phase`): T2-T4 at the eight runs of
     `python3 -m dualpixelface_tpu_torch.tools.bench_vpu_prims` (G = 4096)
     and T1 at the four stride-1 hourglass sites of
     `python3 -m dualpixelface_tpu_torch.tools.bench_dslice_fold` (768x576,
     batch 4), each checked against its plain version and then driven
     through its tool's measurement, timed beside its bound, T1 in bf16
     and in f32; before them, T4 at ragged m (1, 33, 130) and k (8, 72,
     2248), f32 and bf16; each T1 and T4 check names its route;
  10. the trainer (`train/trainer.Trainer`) on the run config
     `train_synthetic_stereodpnet_plus` as committed (f32, Adam, 2
     DataLoader workers, pinned memory), batch 4 at 768x576 crops, SyntheticDP
     cut to 2 train steps and 2 eval batches (the second padded): `fit()`
     then `test()` with the launch counts held per train step (K1 2, K2 2,
     K3 3, K4 3, K5 2) and per eval forward (K1 2, K3 1, K5 2), one
     checkpoint, a train and a test record with finite losses, and a fresh
     trainer restoring the checkpoint in test mode giving the same metric
     aggregates to rtol 1e-4; it prints steps per second, the seconds the
     loop waited on the DataLoader, the peak memory, the host
     preprocessing path (native where `native/libdphost.so` is built, else
     numpy) and the f32 kernels' device ms in one more train step;
  10b. the CLI as a user calls it, `python -m dualpixelface_tpu_torch.main
     --config <tmp>/configs/smoke.json --workspace chip_smoke` in a
     subprocess (the same run config with epoch 1: 8 steps of batch 8 at
     its own 288x192 crops, then a test pass): rc 0, both records, the
     checkpoint; then its workspace is removed. On a machine of two cards or
     more the CLI starts gcd(8, cards) ranks through `parallel.spawn` over
     nccl, which its output must say;
  11. data parallelism: phase 10's run (global batch 4, 768x576, f32,
     Adam, 2 train steps, 2 eval batches with the padded second) on 2 ranks
     started by `parallel.spawn`, each through the Trainer on its 2 rows of
     every batch: on the one card over gloo and, where there are two cards
     or more, on two cards over nccl. Each rank prints its launch counts
     (held to phase 10's per step and per eval forward: the same path at
     half the batch), peak memory, step wall seconds and backend; the ranks
     must hold the same state after every step (digests); rank 0 alone
     writes the records, the log and the checkpoint; rank 0's per-step
     global losses, parameters, BatchNorm buffers and test tables are held
     to phase 10's at DDP_TOL (why those bounds: beside it). A rank that
     fails fails the phase.
  12. the zoo (`stereonet`, `psmnet`, `nnet`, `dpnet`, `bts`) at its
     committed widths through each model's FaceDP run config, f32, seeded
     weights that keep the activations O(1) (`zoo_state_dict`; dpnet's
     BatchNorm statistics those of a train-mode forward), per model:
     12a 3 request batches of 4 at 768x576 through
     `Predictor(dtype=float32)` (every key's shape, finiteness, the peak
     memory, a smoke reading of pairs/s; bts reads the center view); 12b 3
     train steps at the run config's batch (stereonet 4, the others 2),
     Adam (finite losses, every weight moved, the peak memory, the step
     wall); 12a and 12b with the launch counts set to 0 just before and
     read just after, all 0 (the zoo calls the plain soft-argmin, as in
     JAX, and dpnet and bts no kernel of K1-K5); 12c the card's forward
     against the CPU's at 192x192 (psmnet and nnet 256x256: their SPP pools
     need 2C quarter-resolution pixels) with phase 6's tolerances (bts: its
     depth within 1e-4 of max_depth, `zoo_against_cpu` says why); then 12d
     the CLI on the committed `ci_smoke` (stereonet on SyntheticDP, one
     epoch of batch 4) as phase 10b runs it, and on the committed
     `eval_faceDP_dpnet` in test mode on a FaceDP fixture at 768x576,
     restoring the checkpoint that `train/checkpoint.py` wrote from dpnet's
     12b state, each in a subprocess, its workspace removed after.
  13. the last modules: 13a the multi-view training run (dpnet's
     `config_multi`, use_multi, 3 reference views, smoothL1 + the folded
     loss; `data/SyntheticDP/fixture.write_multiview_run`) through
     `Trainer.fit` and `test()` at 768x576, batch 2, f32, 3 steps and 2
     eval batches on a FaceDP multi-view fixture: launch counts all 0,
     every parameter moved, each step's folded loss finite and non-zero,
     the folded loss's forward ms per step (CUDA events), steps/s, the
     step wall, the peak memory; 13a' one step at 96x96 from seeded
     weights, the card against the CPU (losses, each parameter's gradient);
     13b the same run through the CLI (2 steps of batch 3 at 288x192); 13c
     `FaceMaskEstimator` at size 512 on a 768x576 image from a
     reference-named state_dict file, the card against the CPU (logits,
     mask agreement), ms per image, peak memory; 13d `DeformConvPack2D`,
     plain and modulated, at [4, 192, 144, 64] with offsets ~N(0, 1),
     forward and gradients, the card against the CPU.
  14. `stereodpnet_plus` at `inplanes` 48 and `level` 24 (WIDE_OVERRIDES;
     K1 and K2 at Cin 51 and 96 with Co 96, K5 at Cin 51 and 96, K3 and K4
     at 24 planes), seeded weights: 14a 3 request batches of 4 at 768x576
     in bf16 (launches per forward K1 2, K3 1, K5 2); 14b 3 bf16 train steps
     of batch 2, Adam (per step K1 2, K2 2, K3 3, K4 3, K5 2); 14c the card's
     f32 forward against the CPU's at 192x192 (phase 6's tolerances); 14d
     the general deform surface, the card against the CPU in f32, forward
     and every gradient on [2, 8, 96, 72, 32]: `deform_conv3d` at stride 2
     and dilation 2 and at kernel (1, 3, 3) with padding (0, 1, 1) (the
     plain route), `DeformConv3D(dimension="HW")` (K1 and K2 at Co 32),
     `DeformConvPack3D_d(dimension="T")` at stride 2.
  15. a reference checkpoint's eval through the CLI: 15a the committed
     plateau checkpoint written in the reference's format (the port's
     exporter, the reference-only buffers `costrange`, `grid` and a
     `regression_layer` key, seeded BatchNorm counts), converted by the
     CLI entry of `dualpixelface_tpu_torch.tools.convert_stereodpnet_checkpoint`
     (`--config eval_synthetic_stereodpnet`, on the card), then evaluated by
     the committed `eval_synthetic_stereodpnet` (f32 `stereodpnet`, test
     mode, batch 4, `load_strict: true`) through the CLI with
     `--load_model` on SyntheticDP at 768x576 (8 test samples: 2 batches):
     rc 0, a finite test record; the same checkpoint through `Trainer.test`
     in this process, launches per forward K1 2, K5 2, the rest 0, its
     record equal to the CLI's within REFERENCE_RECORD_RTOL (a1-a3, shares
     of pixels, within RECORD_PIXEL_FLIPS pixels); the checkpoint
     exported back (`export_stereodpnet_checkpoint`) equal to the `.pt` and
     to the reference payload, tensor for tensor; 15b
     `metrics.affine_dp.metrics_torch` on the card on 15a's f32 outputs and
     on the bf16 `stereodpnet_plus` serving forward of the same batch, each
     against the same function on CPU copies (METRICS_TOL), the f32 case
     also against the numpy pack (NUMPY_METRICS_TOL), the bf16 one with its
     tie share printed; ms per batch of the card's twin and of the numpy
     pack.
The kernel checks (phases 3-4d, 9 and 14d) run with TF32 off for cuDNN and CUDA
matmuls, scoped: every other phase runs at the port's own setting, which
an f32 Trainer or Predictor applies (`ops.precision.exact_f32`), and
phase 10 fails unless its f32 Trainer turned both flags off from torch's
defaults.
Each phase prints its wall seconds (`phase_seconds`).
Then one line sets K5's bf16 time beside cuDNN's faster layout and T1's
beside the ConvBN3D + ReLU chain, summed over their shapes, and T1's and
T4's f32 times beside cuDNN's and `torch.bmm`'s exact f32 (a reading, not
a check).
The line before the last is the `kernels` JSON with nine rows (launches:
K1-K5 the train path's run of phase 7, `launches_serving` phase 5's,
`launches_serving_exact` phase 5b's, `launches_train_bench` phase 7b's,
`launches_trainer` phase 10's, fit and test, `launches_ddp` phase 11's
per rank on the one card, fit and test, every row; K1-K5 `launches_zoo`
phase 12's per model (the five), 12a and 12b; `launches_last_modules`
phase 13's (13a, 13c, 13d), all 0; `launches_wide` phase 14a's and 14b's;
`launches_reference_eval` phase 15a's in-process eval, every row (K1 and K5
4 each, the rest 0);
K1-K4 a `wide_route` object: phase 4d's times per dtype beside their
bounds (bf16 as the row's, f32 with the contractions as 3xTF32); K1, K2
and K5 also an `f32_route`
object: their f32 route at the trainer path's batch 4, ms, device ms,
plain ms, library ms (K5: cuDNN's exact f32), the bound with every
operation on the CUDA cores (`bound_ms`) and the split bound with the
contractions as 3xTF32 on the tensor cores and the rest on the CUDA cores
(`split_bound_ms`), launches per trainer step;
T1-T4 the tools' measurements in phase 9, whose T rows sum the runs' times
and bounds (T1's and T4's the bf16 runs; T1's and T4's f32 route in an
`f32_route` object as the K rows', at the tools' shapes: ms, device ms,
plain ms, library ms (T1: cuDNN's exact f32 conv, the faster layout, and
`chain_ms`, the f32 ConvBN3D + ReLU chain; T4: `torch.bmm` in exact f32),
the CUDA-core and split bounds, launches); K1-K5 also carry `device_ms`,
phases 4-4c's time on the device alone); the last line is {"ok": true,
"device": {...}}.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Serving path shapes (stereodpnet_plus at 768x576, batch 4): the ANM volume
# is [B, K=4, H/4, W/4, C] with C = 35 into deform_conv1, 64 into deform_conv2.
B, H, W = 4, 768, 576
ANM_SHAPE = (B, 4, H // 4, W // 4)
CINS = (35, 64)
COUT = 64
REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # of max(1, max|plain|)

# Train path shapes (batch 2 at 768x576): the ANM volume [2, 4, 192, 144, C].
TB = 2
TRAIN_ANM_SHAPE = (TB, 4, H // 4, W // 4)
# backward tolerances, of max(1, max|plain|). gx and goff as the forward's
# (f32 sums of <= 27 x 8 terms; bf16: the plain version rounds gcols and the
# results once, the kernel likewise, in another order: goff sums 64 channels
# of rounded gcols, hence 2e-2). gw sums 221,184 voxel products per entry in
# f32: the two orders differed by 2.2e-6 of the largest entry (f32, on an
# H100 80GB HBM3 at 700 W), held to 2e-5; in bf16 the output's own rounding
# decides.
BWD_TOL = {"float32": {"gx": 1e-4, "goff": 1e-4, "gw": 2e-5, "gb": 1e-4},
           "bfloat16": {"gx": 1e-2, "goff": 2e-2, "gw": 2e-2, "gb": 1e-2}}

# The trainer path's shapes (phase 10: the committed f32 run config at
# batch 4, train_faceDP's, on 768x576 crops): the ANM volume
# [4, 4, 192, 144, C] and the coarse logits [4, 8, 192, 144], in f32.
TRAINER_BATCH = 4
TRAINER_ANM_SHAPE = (TRAINER_BATCH, 4, H // 4, W // 4)

# The least f32 work (FMA = 2 operations) per (voxel, tap, input channel)
# outside the contractions, which run on the tensor cores; the per-(voxel,
# tap) positions and corner weights are shared by the channels (35 or 64)
# and left out. K1: the trilinear sample from its 8 corners with the voxel
# tap's 8 corner weights, 1 multiply + 7 FMA = 15. K2: the sample and its 3
# position derivatives, factorised (x: 4 corner-pair differences + 4 FMA =
# 12; y: 2 + 2 FMA = 6; z: 1 + 1 FMA = 3, whose difference is d/dz; d/dy:
# the 2 y differences lerped in z, 3; d/dx: the 4 x differences against the
# 4 (y, z) weights, 1 multiply + 3 FMA = 7): 31; gx, each corner's share
# gcols x weight added into its sum, 8 FMA = 16; goff, gcols x each
# derivative summed over the channels, 3 FMA = 6: 53 in all.
K1_F32_OPS = 15
K2_F32_OPS = 53

# The widths past the committed ones (every width the TPU kernels take):
# K1 and K2 at each (Cin, Co) of WIDTH_CINS x WIDTH_COS on the ANM's D = 4
# and the trainer's 192x144 plane, batch 1 (phases 3 and 3b); K5 at the
# ANM's Cin at `inplanes` 48 (phase 3); K3 and K4 at more coarse planes
# than the compiled-tap kernels' 16 (phase 3d). The same tolerances.
WIDTH_CINS = (3, 15, 51, 96, 131)
WIDTH_COS = (16, 24, 96, 128)
WIDTH_SHAPE = (1, 4, H // 4, W // 4)
K5_WIDE_CINS = (51, 96)
WIDE_PLANES = (17, 24, 64)

# phase 3c: [B, D, H, W] of K1's, K5's, T1's and K2's ragged checks: M = 10, 378, 4, 15
# (no multiple of a 128-voxel tile), H = 2 and 1, W = 2 and 1, D = 1
EDGE_SHAPES = ((1, 1, 2, 5), (2, 3, 7, 9), (1, 2, 1, 2), (3, 5, 1, 1))

TPU_SITES = {
    "K1": "dualpixelface_tpu/ops/kernels/deform_fused.py:598",
    "K2": "dualpixelface_tpu/ops/kernels/deform_fused.py:985",
    "K3": "dualpixelface_tpu/ops/kernels/fused_softargmin.py:238",
    "K4": "dualpixelface_tpu/ops/kernels/fused_softargmin.py:198",
    "K5": "dualpixelface_tpu/ops/kernels/conv3d_dslice.py:207",
    "T1": "tools/attic/conv3d_dslice_v2.py:139",
    "T2": "tools/bench_vpu_prims.py:39",
    "T3": "tools/bench_vpu_prims.py:70",
    "T4": "tools/bench_vpu_prims.py:94",
}
SOURCES = {"K1": "deform_conv3d.cu", "K2": "deform_conv3d_bwd.cu", "K3": "fused_softargmin.cu",
           "K4": "fused_softargmin_bwd.cu", "K5": "conv3d_dslice.cu", "T1": "conv3d_dslice_v2.cu",
           "T2": "prims_gather.cu", "T3": "prims_transpose.cu", "T4": "prims_dot.cu"}
NAMES = {"K1": "deform_conv3d_fused", "K2": "deform_conv3d_bwd", "K3": "fused_softargmin",
         "K4": "fused_softargmin_bwd", "K5": "conv3d_dslice", "T1": "conv3d_dslice_v2", "T2": "lane_gather_sum",
         "T3": "transpose_sum", "T4": "batched_dot"}


# torch's defaults for the two TF32 flags (cuDNN's convolutions, CUDA
# matmuls), as a fresh process has them
TORCH_TF32_DEFAULTS = (True, False)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str) -> list[dict]:
    """Per entry function of an `nvcc -Xptxas=-v` log: its mangled name,
    registers, static shared memory and spill bytes."""
    funcs = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            funcs.append({"function": m.group(1)})
        elif funcs and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            funcs[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif funcs and (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)):
            funcs[-1].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return funcs


def print_build_report(report: dict) -> None:
    """Phase 2's report: each entry function's registers, shared memory
    (static, and for the tensor-core kernels and K4 the dynamic shared
    memory their C entry points report) and spill bytes; fails if a
    tensor-core kernel or an instantiation of K3 or K4 spills or is missing
    from the log."""
    import ctypes

    from dualpixelface_tpu_torch.ops.kernels import _build

    def smem(lib, symbol, *args):
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        return fn(*args)

    # (library, kernel, template argument) of each tensor-core instantiation
    dynamic = {("conv3d_dslice", "conv3d_tc_kernel", 88): smem("conv3d_dslice", "dpf_conv3d_k3_smem_bytes"),
               ("conv3d_dslice", "conv3d_3xtf32_kernel", 88): smem("conv3d_dslice", "dpf_conv3d_k3_3xtf32_smem_bytes")}
    dynamic.update({("conv3d_dslice_v2", "conv3d_tc_kernel", co):
                    smem("conv3d_dslice_v2", "dpf_conv3d_k3_affine_smem_bytes", co) for co in (32, 64)})
    dynamic.update({("conv3d_dslice_v2", "conv3d_3xtf32_kernel", co):
                    smem("conv3d_dslice_v2", "dpf_conv3d_k3_affine_3xtf32_smem_bytes", co) for co in (32, 64)})
    dynamic.update({("prims_dot", "dot_bf16_kernel", mt): smem("prims_dot", "dpf_batched_dot_smem_bytes", mt)
                    for mt in (1, 2)})
    dynamic.update({("prims_dot", "dot_3xtf32_kernel", mt):
                    smem("prims_dot", "dpf_batched_dot_3xtf32_smem_bytes", mt) for mt in (1, 2)})
    dynamic.update({("deform_conv3d_bwd", "deform_bwd_tc_kernel", cp):
                    smem("deform_conv3d_bwd", "dpf_deform_conv3d_bwd_tc_smem_bytes") for cp in (40, 64)})
    dynamic.update({("deform_conv3d_bwd", "deform_bwd_3xtf32_kernel", cp):
                    smem("deform_conv3d_bwd", "dpf_deform_conv3d_bwd_3xtf32_smem_bytes", cp) for cp in (40, 64)})
    dynamic.update({("deform_conv3d", "deform_fwd_tc_kernel", cp):
                    smem("deform_conv3d", "dpf_deform_conv3d_tc_smem_bytes", cp) for cp in (40, 64)})
    dynamic.update({("deform_conv3d", "deform_fwd_3xtf32_kernel", cp):
                    smem("deform_conv3d", "dpf_deform_conv3d_3xtf32_smem_bytes", cp) for cp in (40, 64)})
    # K1's and K2's wide forms (any Cin, any Co): the 64-channel instantiations'
    # shared memory, <64, true>
    for lib, kernel in (("deform_conv3d", "deform_fwd_tc_kernel"), ("deform_conv3d", "deform_fwd_3xtf32_kernel"),
                        ("deform_conv3d_bwd", "deform_bwd_tc_kernel"), ("deform_conv3d_bwd", "deform_bwd_3xtf32_kernel")):
        dynamic[(lib, kernel, 64, "wide")] = dynamic[(lib, kernel, 64)]
    # K3's and K4's instantiations: each dtype and D = 1..16, and each
    # dtype's wide form (D > 16); none may spill
    fsam = {(k, t, d) for k in ("fwd", "bwd") for t in ("f", "13__nv_bfloat16") for d in (*range(1, 17), "wide")}
    seen = set()
    for name, r in report.items():
        for warning in re.findall(r".*Potential Performance Loss.*", r["log"]):
            print(f"ptxas {name}: {warning.strip()}", flush=True)
        for f in ptxas_report(r["log"]):
            line = (f"ptxas {name}: {f['function']}: {f.get('registers')} registers, {f.get('static_smem')} bytes "
                    f"static smem, spill stores {f.get('spill_stores')} / loads {f.get('spill_loads')} bytes")
            if m := re.search(r"fsam_(fwd|bwd)_(?:kernelI(f|13__nv_bfloat16)Li(\d+)E|wide_kernelI(f|13__nv_bfloat16)E)",
                              f["function"]):
                key = (m.group(1), m.group(2) or m.group(4), int(m.group(3)) if m.group(3) else "wide")
                fsam.discard(key)
                if key[0] == "bwd":
                    line += f", dynamic smem {smem('fused_softargmin_bwd', 'dpf_fused_softargmin_bwd_smem_bytes', 16 if key[2] == 'wide' else key[2])} bytes"
                if f.get("spill_stores") != 0 or f.get("spill_loads") != 0:
                    fail(f"the K3/K4 kernel {f['function']} spills: {f}")
            if m := re.search(r"(conv3d_tc|conv3d_3xtf32|dot_bf16|dot_3xtf32|deform_bwd_tc|deform_bwd_3xtf32|"
                              r"deform_fwd_tc|deform_fwd_3xtf32)(?:_kernelILi(\d+)E(Lb1E)?|_wide_kernel)",
                              f["function"]):
                # a wide form: the <64, true> instantiation, or K2 f32's own kernel
                key = (name, m.group(1) + "_kernel", int(m.group(2) or 64)) + (
                    ("wide",) if m.group(3) or not m.group(2) else ())
                seen.add(key)
                line += f", dynamic smem {dynamic[key]} bytes ({key[1]}<{key[2]}{', true' if len(key) > 3 else ''}>)"
                if f.get("spill_stores") != 0 or f.get("spill_loads") != 0:
                    fail(f"the tensor-core kernel {f['function']} spills: {f}")
            print(line, flush=True)
    if seen != set(dynamic):
        fail(f"the build log reports tensor-core kernels {sorted(seen)}, not {sorted(dynamic)}")
    if fsam:
        fail(f"the build log lacks K3/K4 instantiations {sorted(fsam, key=str)}")


def compare(name: str, got, ref, dtype_name: str, rel_tol: float | None = None) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    if got.dtype != ref.dtype:
        fail(f"{name}: dtype {got.dtype} != plain {ref.dtype}")
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = float((got - ref).abs().max())
    tol = (REL_TOL[dtype_name] if rel_tol is None else rel_tol) * max(1.0, float(ref.abs().max()))
    print(f"check {name} {dtype_name}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        fail(f"{name} {dtype_name}: kernel disagrees with its plain version: {err} > {tol}")
    return err


def kernel_inputs(torch, gen, cin, dtype, shape=ANM_SHAPE, on_bound=False):
    dev = "cuda"
    x = torch.randn(shape + (cin,), generator=gen, device=dev).to(dtype)
    off = torch.randn(shape + (81,), generator=gen, device=dev) * 2.0
    # a quarter of the offsets are whole numbers: positions exactly on the grid
    whole = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(whole, torch.round(off), off)
    if on_bound:
        # a tenth of the H/W offsets exactly on the window bound, where the
        # aperture clamp passes half the gradient
        k = torch.arange(81, device=dev)
        kh = ((k // 3 // 3) % 3 - 1).float()
        kw = ((k // 3) % 3 - 1).float()
        lo = torch.where(k % 3 == 1, -3.0 - kh, -3.0 - kw)
        hi = torch.where(k % 3 == 1, 4.0 - 1.0 / 1024 - kh, 4.0 - 1.0 / 1024 - kw)
        pick = (torch.rand(off.shape, generator=gen, device=dev) < 0.1) & (k % 3 != 0)
        high = torch.rand(off.shape, generator=gen, device=dev) < 0.5
        off = torch.where(pick, torch.where(high, hi, lo), off)
    off = off.to(dtype)
    w = (torch.randn((3, 3, 3, cin, COUT), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    bias = torch.randn((COUT,), generator=gen, device=dev).to(dtype)
    w_off = (torch.randn((3, 3, 3, cin, 81), generator=gen, device=dev) / math.sqrt(27 * cin)).to(dtype)
    b_off = torch.randn((81,), generator=gen, device=dev).to(dtype)
    return x, off, w, bias, w_off, b_off


def width_inputs(torch, gen, cin, co, dtype, shape=WIDTH_SHAPE):
    """`kernel_inputs`' x and offsets (a quarter of them whole numbers, a
    tenth of the H/W ones on the window bound), and a weight, bias and
    cotangent of Co = co."""
    x, off, _, _, _, _ = kernel_inputs(torch, gen, cin, dtype, shape, on_bound=True)
    w = (torch.randn((3, 3, 3, cin, co), generator=gen, device="cuda") / math.sqrt(27 * cin)).to(dtype)
    bias = torch.randn((co,), generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape + (co,), generator=gen, device="cuda").to(dtype)
    return x, off, w, bias, g


@contextlib.contextmanager
def kernel_checks_in_f32(torch):
    """TF32 off for cuDNN's convolutions and CUDA matmuls inside the block
    (the kernel checks of phases 3-4c and 9 hold each kernel against its
    plain version in IEEE f32), then both flags as they were: the phases
    after it run at the port's own setting (`ops.precision.exact_f32`,
    which an f32 Trainer or Predictor applies)."""
    saved = tf32_flags(torch)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_flags(torch) -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def check_and_time_kernels(torch):
    from dualpixelface_tpu_torch.tools import cuda_ms, cudnn_conv3d_calls, device_ms
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice, conv3d_dslice_plain, route
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import deform_conv3d_fused, deform_conv3d_plain, fwd_route

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    err = {"K1": 0.0, "K5": 0.0}
    timing = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0, "bytes": 0.0,
                  "flops_f32": 0.0} for k in err}

    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in CINS:
            x, off, w, bias, w_off, b_off = kernel_inputs(torch, gen, cin, dtype)
            for aperture in (True, False):
                e = compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] Cin={cin} aperture={aperture}",
                            deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                            deform_conv3d_plain(x, off, w, bias, aperture=aperture), dname)
                if dtype == bf16 and aperture:
                    err["K1"] = max(err["K1"], e)
            e = compare(f"K5 conv3d_dslice [{route(dtype)}] Cin={cin}", conv3d_dslice(x, w_off, b_off),
                        conv3d_dslice_plain(x, w_off, b_off), dname)
            if dtype == bf16:
                err["K5"] = max(err["K5"], e)
            if dtype != bf16:
                continue
            # timing at the serving dtype; the two Cin shapes of one forward add up
            k1 = timing["K1"]
            m = math.prod(ANM_SHAPE)
            run = {"cin": cin, "route": fwd_route(dtype),
                   "ms": cuda_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5),
                   "device_ms": device_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5),
                   "plain_ms": cuda_ms(lambda: deform_conv3d_plain(x, off, w, bias, aperture=True), 2),
                   "flops": 2.0 * m * 27 * cin * COUT}
            run["tflops"] = run["flops"] / run["ms"] / 1e9
            print(json.dumps({"K1_run": run}), flush=True)
            k1.setdefault("runs", []).append(run)
            k1["ms"] += run["ms"]
            k1["device_ms"] += run["device_ms"]
            k1["plain_ms"] += run["plain_ms"]
            k1["flops"] += run["flops"]
            k1["flops_f32"] += K1_F32_OPS * m * 27 * cin
            k1["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w, bias)) + m * COUT * 2
            k5 = timing["K5"]
            run = {"cin": cin, "ms": cuda_ms(lambda: conv3d_dslice(x, w_off, b_off), 5),
                   "device_ms": device_ms(lambda: conv3d_dslice(x, w_off, b_off), 5),
                   "plain_ms": cuda_ms(lambda: conv3d_dslice_plain(x, w_off, b_off), 2),
                   "flops": 2.0 * m * 27 * cin * 81}
            for layout, call in cudnn_conv3d_calls(x, w_off, b_off).items():
                run[f"cudnn_{layout}_ms"] = cuda_ms(call, 5)
            run["cudnn_layout"] = min(("ncdhw", "channels_last_3d"), key=lambda k: run[f"cudnn_{k}_ms"])
            run["cudnn_ms"] = run[f"cudnn_{run['cudnn_layout']}_ms"]
            run["tflops"] = run["flops"] / run["ms"] / 1e9
            print(json.dumps({"K5_run": run}), flush=True)
            k5.setdefault("runs", []).append(run)
            k5["ms"] += run["ms"]
            k5["device_ms"] += run["device_ms"]
            k5["plain_ms"] += run["plain_ms"]
            k5["library_ms"] = (k5["library_ms"] or 0.0) + run["cudnn_ms"]
            k5["flops"] += run["flops"]
            k5["bytes"] += sum(t.numel() * t.element_size() for t in (x, w_off, b_off)) + m * 81 * 2

    # every width: K1 at WIDTH_CINS x WIDTH_COS (its wide form but at Cin
    # <= 64 with Co 64), both routes and apertures; K5 at the ANM's Cin of
    # `inplanes` 48 (its Co stays 81)
    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in WIDTH_CINS:
            for co in WIDTH_COS:
                x, off, w, bias, _ = width_inputs(torch, gen, cin, co, dtype)
                for aperture in (True, False):
                    compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] {WIDTH_SHAPE} Cin={cin} Co={co} "
                            f"aperture={aperture}", deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                            deform_conv3d_plain(x, off, w, bias, aperture=aperture), dname)
        for cin in K5_WIDE_CINS:
            x, _, _, _, w_off, b_off = kernel_inputs(torch, gen, cin, dtype)
            compare(f"K5 conv3d_dslice [{route(dtype)}] Cin={cin}", conv3d_dslice(x, w_off, b_off),
                    conv3d_dslice_plain(x, w_off, b_off), dname)
        torch.cuda.empty_cache()

    # the f32 routes at the batch a data-parallel rank gives them (phase 11)
    f32 = torch.float32
    for cin in CINS:
        x, off, w, bias, w_off, b_off = kernel_inputs(torch, gen, cin, f32, TRAIN_ANM_SHAPE)
        for aperture in (True, False):
            compare(f"K1 deform_conv3d_fused [{fwd_route(f32)}] B={TB} Cin={cin} aperture={aperture} (a rank's)",
                    deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                    deform_conv3d_plain(x, off, w, bias, aperture=aperture), "float32")
        compare(f"K5 conv3d_dslice [{route(f32)}] B={TB} Cin={cin} (a rank's)", conv3d_dslice(x, w_off, b_off),
                conv3d_dslice_plain(x, w_off, b_off), "float32")

    # the f32 routes at the trainer path's batch 4 (phase 10, which every
    # committed f32 run trains on), checked and timed (`f32_work`): K1 and
    # K5 in 3xTF32 on the tensor cores.
    m = math.prod(TRAINER_ANM_SHAPE)
    for k in ("K1", "K5"):
        timing[k]["f32_route"] = f32_work()
    for cin in CINS:
        x, off, w, bias, w_off, b_off = kernel_inputs(torch, gen, cin, f32, TRAINER_ANM_SHAPE)
        compare(f"K1 deform_conv3d_fused [{fwd_route(f32)}] B={TRAINER_BATCH} Cin={cin} aperture=True (the trainer's)",
                deform_conv3d_fused(x, off, w, bias, aperture=True),
                deform_conv3d_plain(x, off, w, bias, aperture=True), "float32")
        compare(f"K5 conv3d_dslice [{route(f32)}] B={TRAINER_BATCH} Cin={cin} (the trainer's)",
                conv3d_dslice(x, w_off, b_off),
                conv3d_dslice_plain(x, w_off, b_off), "float32")
        k1 = timing["K1"]["f32_route"]
        k1["ms"] += cuda_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5)
        k1["device_ms"] += device_ms(lambda: deform_conv3d_fused(x, off, w, bias, aperture=True), 5)
        k1["plain_ms"] += cuda_ms(lambda: deform_conv3d_plain(x, off, w, bias, aperture=True), 1)
        k1["flops_mma"] += 2.0 * COUT * m * 27 * cin
        k1["ops_f32"] += K1_F32_OPS * m * 27 * cin
        k1["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w, bias)) + m * COUT * 4
        k5 = timing["K5"]["f32_route"]
        k5["ms"] += cuda_ms(lambda: conv3d_dslice(x, w_off, b_off), 5)
        k5["device_ms"] += device_ms(lambda: conv3d_dslice(x, w_off, b_off), 5)
        k5["plain_ms"] += cuda_ms(lambda: conv3d_dslice_plain(x, w_off, b_off), 1)
        # cuDNN's exact f32 (TF32 is off in this scope), the faster layout
        k5["library_ms"] = (k5["library_ms"] or 0.0) + min(
            cuda_ms(call, 5) for call in cudnn_conv3d_calls(x, w_off, b_off).values())
        k5["flops_mma"] += 2.0 * m * 27 * cin * 81
        k5["bytes"] += sum(t.numel() * t.element_size() for t in (x, w_off, b_off)) + m * 81 * 4
        torch.cuda.empty_cache()
    return err, timing


def f32_work() -> dict:
    """A kernel's f32-route timing at the trainer path's shapes: ms, device
    ms, plain ms, library ms, and its least work: the contractions' f32
    operations (an FMA as 2), the other f32 operations, and bytes."""
    return {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops_mma": 0.0, "ops_f32": 0.0,
            "bytes": 0.0}


def check_and_time_backward_kernels(torch, err, timing):
    """Phases 3b and 4b: K2 against autograd through its plain version at
    the train path's shapes, in f32 and bf16; its times at bf16, the train
    dtype, with CUDA events and on the device alone. The plain K2 at this shape holds ~30 GB of
    autograd state, so each comparison frees it before the next. Then K2's
    f32 route at the trainer path's batch 4 (`TRAINER_ANM_SHAPE`), Cin 35
    and 64, both apertures, within the same `BWD_TOL`: the plain version
    runs on the two batch-2 halves (its autograd state at batch 4 would be
    ~60 GB), gx and goff concatenated, gw and gb summed."""
    from dualpixelface_tpu_torch.tools import cuda_ms, device_ms
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    err["K2"] = 0.0
    timing["K2"] = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0, "bytes": 0.0,
                    "flops_f32": 0.0}
    m = math.prod(TRAIN_ANM_SHAPE)
    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in CINS:
            x, off, w, bias, _, _ = kernel_inputs(torch, gen, cin, dtype, TRAIN_ANM_SHAPE, on_bound=True)
            g = torch.randn(TRAIN_ANM_SHAPE + (COUT,), generator=gen, device="cuda").to(dtype)
            for aperture in (True, False):
                got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
                ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=aperture)
                for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                    e = compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} Cin={cin} aperture={aperture}",
                                a, r, dname, BWD_TOL[dname][gname])
                    if dtype == bf16 and aperture:
                        err["K2"] = max(err["K2"], e)
                del got, ref
                torch.cuda.empty_cache()
            if dtype != bf16:
                continue
            k2 = timing["K2"]
            k2["ms"] += cuda_ms(lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True), 3)
            k2["device_ms"] += device_ms(lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True), 3)
            k2["plain_ms"] += cuda_ms(lambda: deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=True), 1)
            torch.cuda.empty_cache()
            # two contractions (gcols = g W^T, gw = cols^T g), twice K1's,
            # and the gather work (K2_F32_OPS per voxel, tap and channel)
            k2["flops"] += 2 * 2.0 * m * 27 * cin * COUT
            k2["flops_f32"] += K2_F32_OPS * m * 27 * cin
            # x, offset, weight and g read; gx, goff and gw written
            k2["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w)) * 2 + g.numel() * g.element_size()

    # every width: K2 at WIDTH_CINS x WIDTH_COS, both routes and apertures
    for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
        for cin in WIDTH_CINS:
            for co in WIDTH_COS:
                x, off, w, bias, g = width_inputs(torch, gen, cin, co, dtype)
                for aperture in (True, False):
                    got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
                    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=aperture)
                    for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                        compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} {WIDTH_SHAPE} Cin={cin} Co={co} "
                                f"aperture={aperture}", a, r, dname, BWD_TOL[dname][gname])
                    del got, ref
                torch.cuda.empty_cache()

    timing["K2"]["f32_route"] = k2 = f32_work()
    m = math.prod(TRAINER_ANM_SHAPE)
    for cin in CINS:
        x, off, w, bias, _, _ = kernel_inputs(torch, gen, cin, torch.float32, TRAINER_ANM_SHAPE, on_bound=True)
        g = torch.randn(TRAINER_ANM_SHAPE + (COUT,), generator=gen, device="cuda")
        for aperture in (True, False):
            got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
            ref = bwd_plain_in_halves(torch, x, off, w, bias, g, aperture)
            for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                compare(f"K2 deform_conv3d_bwd [{bwd_route(torch.float32)}] {gname} B={TRAINER_BATCH} Cin={cin} "
                        f"aperture={aperture} (the trainer's)", a, r, "float32", BWD_TOL["float32"][gname])
            del got, ref
            torch.cuda.empty_cache()
        # the f32 route's time at the trainer's aperture (the windowed
        # deform of D = 4 planes); the plain version on the two halves
        k2["ms"] += cuda_ms(lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True), 3)
        k2["device_ms"] += device_ms(lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True), 3)
        k2["plain_ms"] += cuda_ms(lambda: bwd_plain_in_halves(torch, x, off, w, bias, g, True), 1)
        k2["flops_mma"] += 2 * 2.0 * COUT * m * 27 * cin
        k2["ops_f32"] += K2_F32_OPS * m * 27 * cin
        k2["bytes"] += sum(t.numel() * t.element_size() for t in (x, off, w)) * 2 + g.numel() * g.element_size()
        torch.cuda.empty_cache()


def bwd_plain_in_halves(torch, x, off, w, bias, g, aperture):
    """K2's plain version in f32 on each half of the batch, its gradients
    joined (gx and goff) or summed (gw and gb): at the full batch its
    autograd state would not fit on the card."""
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import deform_conv3d_bwd_plain

    halves = []
    for rows in (slice(0, x.shape[0] // 2), slice(x.shape[0] // 2, None)):
        halves.append(deform_conv3d_bwd_plain(x[rows], off[rows], w, bias, g[rows], aperture=aperture))
        torch.cuda.empty_cache()
    (gx0, goff0, gw0, gb0), (gx1, goff1, gw1, gb1) = halves
    return torch.cat([gx0, gx1]), torch.cat([goff0, goff1]), gw0 + gw1, gb0 + gb1


# K3 and K4 (phase 3d): the coarse plane counts held at the paths' shape
# (the configs' 8, and 5 and 16; at (50, 36) every D the kernels are
# instantiated for), and the wide-logit cases: logits of scale 30; one
# coarse cell whose planes are all near -200, past exp's f32 range
# unshifted (near -1e4 the plain version's own f32 rounding strays further
# from the exact value than REL_TOL: tests/test_torch_softargmin_pack.py);
# one whose plane 3 is 0 and the others -3000, so every bin of the pixels
# around it lies more than f32's range below the max over the planes (both
# kernels shift by the largest bin)
SOFTARGMIN_PLANES = (8, 5, 16)


def softargmin_cost(torch, gen, b, d, hw, dtype, wide=False):
    cost = torch.randn((b, d) + hw, generator=gen, device="cuda") * (30.0 if wide else 3.0)
    if wide:
        cost[:, :, 1, 2] = -200.0 + torch.randn((b, d), generator=gen, device="cuda")
        cost[:, :, 5, 5] = -3000.0
        cost[:, 3, 5, 5] = 0.0
    return cost.to(dtype)


def check_and_time_softargmin(torch, err, timing):
    """Phases 3d and 4c: K3 at the serving batch (4) and K4 at the train
    batch (2), at the path's coarse shape (192 x 144) for D in
    SOFTARGMIN_PLANES and at (50, 36) (4h % 32 != 0) for D = 1..16, in f32
    and bf16, then the wide-logit cases at (50, 36), D = 8, against their
    plain versions
    within REL_TOL; K4 twice on the same inputs, which must agree bit for
    bit. Then each kernel's time at its path's shape in bf16: event-timed
    (`cuda_ms`, the host's dispatch included) and on the device alone
    (`device_ms`), beside its plain version and its bound (bytes, f32
    operations and exps, `tools.bench_softargmin.work`). Also K4 in f32 at
    the trainer path's batch 4, D = 8, (192, 144) (K3's f32 check at that
    shape is the first case above), and K3 in f32 at a data-parallel rank's
    batch 2 (K4's at that shape is the first case above)."""
    from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import (
        fused_softargmin, fused_softargmin_bwd, fused_softargmin_bwd_plain, fused_softargmin_plain)
    from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
    from dualpixelface_tpu_torch.tools import bench_softargmin, cuda_ms, device_ms

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(d, (H // 4, W // 4), False) for d in SOFTARGMIN_PLANES + WIDE_PLANES]
    cases += [(d, (50, 36), False) for d in (*range(1, 17), *WIDE_PLANES)]
    cases += [(8, (50, 36), True), (24, (50, 36), True)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for d, hw, wide in cases:
            disp = regression_disparities(-4, 12, d, 4)
            label = f"D={d} h,w={hw}" + (" wide logits" if wide else "")
            cost = softargmin_cost(torch, gen, B, d, hw, dtype, wide)
            e = compare(f"K3 fused_softargmin B={B} {label}", fused_softargmin(cost, disp, 4),
                        fused_softargmin_plain(cost, disp, 4), dname)
            if dtype == torch.bfloat16 and (d, hw, wide) == cases[0]:
                err["K3"] = e
            cost = softargmin_cost(torch, gen, TB, d, hw, dtype, wide)
            g = torch.randn((TB, 4 * hw[0], 4 * hw[1]), generator=gen, device="cuda").to(dtype)
            got = fused_softargmin_bwd(cost, g, disp, 4)
            e = compare(f"K4 fused_softargmin_bwd B={TB} {label}", got,
                        fused_softargmin_bwd_plain(cost, g, disp, 4), dname)
            if dtype == torch.bfloat16 and (d, hw, wide) == cases[0]:
                err["K4"] = e
            if not torch.equal(got, fused_softargmin_bwd(cost, g, disp, 4)):
                fail(f"K4 {label} {dname}: two calls on the same inputs differ")
        print(f"check K4 {dname}: two calls on the same inputs agree bit for bit in every case", flush=True)

    disp = regression_disparities(-4, 12, 8, 4)
    cost = softargmin_cost(torch, gen, TRAINER_BATCH, 8, (H // 4, W // 4), torch.float32)
    g = torch.randn((TRAINER_BATCH, H, W), generator=gen, device="cuda")
    compare(f"K4 fused_softargmin_bwd B={TRAINER_BATCH} D=8 h,w={(H // 4, W // 4)} (the trainer's)",
            fused_softargmin_bwd(cost, g, disp, 4), fused_softargmin_bwd_plain(cost, g, disp, 4), "float32")
    cost = softargmin_cost(torch, gen, B, 8, (H // 4, W // 4), torch.bfloat16)
    tcost = softargmin_cost(torch, gen, TB, 8, (H // 4, W // 4), torch.bfloat16)
    g = torch.randn((TB, H, W), generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"K3": (lambda: fused_softargmin(cost, disp, 4), lambda: fused_softargmin_plain(cost, disp, 4),
                    tuple(cost.shape)),
             "K4": (lambda: fused_softargmin_bwd(tcost, g, disp, 4),
                    lambda: fused_softargmin_bwd_plain(tcost, g, disp, 4), tuple(tcost.shape))}
    for k, (fn, plain, shape) in calls.items():
        timing[k] = {"ms": cuda_ms(fn, 20), "device_ms": device_ms(fn, 20), "plain_ms": cuda_ms(plain, 3),
                     "library_ms": None, "flops": 0.0, **bench_softargmin.work(k, shape)}
        print(json.dumps({f"{k}_run": {"shape": list(shape), **timing[k]}}), flush=True)
    cost = softargmin_cost(torch, gen, TB, 8, (H // 4, W // 4), torch.float32)
    compare(f"K3 fused_softargmin B={TB} D=8 h,w={(H // 4, W // 4)} (a rank's)", fused_softargmin(cost, disp, 4),
            fused_softargmin_plain(cost, disp, 4), "float32")


def check_edge_shapes(torch):
    """Phase 3c: K1, K5, T1 and K2 at the ragged `EDGE_SHAPES`, Cin 35 and
    64, bf16 and f32: K1 (both apertures, each route) and K5 (each route) within
    `REL_TOL`, T1 (Co 32 and 64, without and with the folded BatchNorm and
    ReLU, each route) within `bench_dslice_fold.excess_error`'s allowance,
    K2 (both apertures, each route) within `BWD_TOL`."""
    from dualpixelface_tpu_torch.ops.kernels import conv3d_dslice_v2 as t1
    from dualpixelface_tpu_torch.ops.kernels.conv3d_dslice import conv3d_dslice, conv3d_dslice_plain, route
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
        bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain, deform_conv3d_fused, deform_conv3d_plain, fwd_route)
    from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, dname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for shape in EDGE_SHAPES:
            for cin in CINS:
                x, _, _, _, w_off, b_off = kernel_inputs(torch, gen, cin, dtype, shape)
                compare(f"K5 conv3d_dslice [{route(dtype)}] {shape + (cin,)}", conv3d_dslice(x, w_off, b_off),
                        conv3d_dslice_plain(x, w_off, b_off), dname)
                for co in t1.COS:
                    for r in fold.check(fold.site_inputs(shape + (cin,), co, gen, dtype)):
                        print(f"check T1 conv3d_dslice_v2 [{t1.route(dtype)}] {shape + (cin,)} -> {co} {dname} "
                              f"ab={r['ab']} relu={r['relu']}: max_abs_err {r['max_abs_err']:.3e}, worst error / "
                              f"allowance {r['worst_ratio']:.3f}", flush=True)
                        if not r["worst_ratio"] <= 1.0:
                            fail(f"T1 {shape + (cin,)} -> {co} {dname}: kernel disagrees with its plain version")
                x, off, w, bias, _, _ = kernel_inputs(torch, gen, cin, dtype, shape, on_bound=True)
                for aperture in (True, False):
                    compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] {shape + (cin,)} aperture={aperture}",
                            deform_conv3d_fused(x, off, w, bias, aperture=aperture),
                            deform_conv3d_plain(x, off, w, bias, aperture=aperture), dname)
                g = torch.randn(shape + (COUT,), generator=gen, device="cuda").to(dtype)
                for aperture in (True, False):
                    got = deform_conv3d_bwd(x, off, w, bias, g, aperture=aperture)
                    ref = deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=aperture)
                    for gname, a, r in zip(("gx", "goff", "gw", "gb"), got, ref):
                        compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} {shape + (cin,)} "
                                f"aperture={aperture}", a, r, dname, BWD_TOL[dname][gname])


def tools_phase(torch):
    """Phase 9: the tools' kernels T1-T4, each checked against its plain
    version at the tools' full sizes and then driven through the tool's own
    measurement (`tools.bench_vpu_prims.measure`, `tools.bench_dslice_fold.
    measure`) with the launch counts set to 0 just before and read just
    after: those counts are the T rows' `launches`.

    T2 and T3 must agree bit for bit (the same adds in the same order and
    dtype); T4 within 1e-4 of max(1, max|plain|) (f32 sums of up to 2248
    exact products in another order; in f32 3xTF32 products, as accurate),
    at the tool's runs and, first, at ragged m and k with G = 64; T1 at the
    four stride-1 hourglass sites in f32 and bf16, without and with the
    folded BatchNorm and ReLU, within 1e-4 of max(1, max|plain|) for the
    sums' order plus, in bf16, one ulp of the output (both round one f32
    value once). A T row sums its bf16 runs (T2, T3: every run); T1's and
    T4's f32 runs, their 3xTF32 route, go to the row's `f32_route` (ms,
    device ms, plain ms, library ms, their work, launches, largest error).
    Each tool's inputs are allocated once per shape and freed before the
    next."""
    from dualpixelface_tpu_torch.ops.kernels import conv3d_dslice_v2 as t1mod
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, prims, reset_launch_counts
    from dualpixelface_tpu_torch.tools import bench_dslice_fold as fold
    from dualpixelface_tpu_torch.tools import bench_vpu_prims as vpu
    from dualpixelface_tpu_torch.tools import cuda_ms, device_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0, "bound_ops_ms": 0.0,
                "err": 0.0, "launches": 0, "runs": []} for k in ("T1", "T2", "T3", "T4")}
    for k in ("T1", "T4"):
        rows[k]["f32_route"] = {"route": "tensor_cores_3xtf32", "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                "library_ms": 0.0, "flops_mma": 0.0, "bytes": 0.0, "launches": 0,
                                "max_abs_err": 0.0, "runs": 0}
    rows["T1"]["f32_route"]["chain_ms"] = 0.0

    def add(row, m, plain_ms, launches):
        row["ms"] += m["ms"]
        row["plain_ms"] += plain_ms
        row["bound_ms"] += m["bound_ms"]
        row["bound_ops_ms"] += m["bound_ms"] if m["bound_by"] == "operations" else 0.0
        row["launches"] += launches
        if m["library_ms"] is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + m["library_ms"]
        row["runs"].append(m)

    def add_f32(row, ms, dev_ms, plain_ms, library_ms, flops, nbytes, launches, **more):
        f = row["f32_route"]
        for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                       ("flops_mma", flops), ("bytes", nbytes), ("launches", launches), ("runs", 1), *more.items()):
            f[key] += v
        row["launches"] += launches

    def err_into(row, dtype, e):
        key, d = ("max_abs_err", row["f32_route"]) if dtype == torch.float32 and "f32_route" in row else ("err", row)
        d[key] = max(d[key], e)

    # T4 at ragged widths first (k * element size stays a multiple of 16
    # bytes, the kernel's granule); these launches precede the counted runs
    for dtype in (torch.float32, torch.bfloat16):
        for m, k in ((m, k) for m in (1, 33, 130) for k in (8, 72, 2248)):
            a = torch.randn((64, m, k), generator=gen, device="cuda").to(dtype)
            b = torch.randn((64, k, prims.DOT_N), generator=gen, device="cuda").to(dtype)
            err_into(rows["T4"], dtype, compare(
                f"T4 batched_dot [{prims.dot_route(dtype)}] [64, {m}, {k}] x [64, {k}, {prims.DOT_N}]",
                prims.batched_dot(a, b), prims.batched_dot_plain(a, b), str(dtype).removeprefix("torch."), 1e-4))

    for run in vpu.RUNS:
        inputs = run.inputs(gen)
        dname = str(run.dtype).removeprefix("torch.")
        dot = run.kind == "dot"
        name = f"{run.kernel_id} [{prims.dot_route(run.dtype)}] {run.label}" if dot else f"{run.kernel_id} {run.label}"
        row = rows[run.kernel_id]
        err_into(row, run.dtype, compare(name, run.kernel(*inputs), run.plain(*inputs), dname, 1e-4 if dot else 0.0))
        plain_ms = cuda_ms(lambda: run.plain(*inputs), 2)
        reset_launch_counts()
        m = vpu.measure(run, inputs)
        n = launch_counts()[run.kernel_id]
        print(json.dumps({**m, "plain_ms": plain_ms, "launches": n}), flush=True)
        if dot and run.dtype == torch.float32:
            add_f32(row, m["ms"], device_ms(lambda: run.kernel(*inputs), 5), plain_ms, m["library_ms"], m["ops"],
                    m["bytes"], n)
        else:
            add(row, m, plain_ms, n)
        del inputs
        torch.cuda.empty_cache()

    t1 = rows["T1"]
    for label, shape, co in fold.SITES:
        for dtype in (torch.float32, torch.bfloat16):
            inp = fold.site_inputs(shape, co, gen, dtype)
            for r in fold.check(inp):
                print(f"check T1 conv3d_dslice_v2 [{t1mod.route(dtype)}] {label} {dtype} ab={r['ab']} "
                      f"relu={r['relu']}: max_abs_err {r['max_abs_err']:.3e}, worst error / allowance "
                      f"{r['worst_ratio']:.3f}", flush=True)
                if not r["worst_ratio"] <= 1.0:
                    fail(f"T1 {label} {dtype}: kernel disagrees with its plain version")
                err_into(t1, dtype, r["max_abs_err"])
            call = (inp["x"], inp["wmat"], inp["ab"])
            plain_ms = cuda_ms(lambda: t1mod.conv3d_dslice_v2_plain(*call, relu=True), 1)
            reset_launch_counts()
            m = fold.measure(label, inp)
            n = launch_counts()["T1"]
            print(json.dumps({**m, "plain_ms": plain_ms, "launches": n}), flush=True)
            if dtype == torch.float32:
                add_f32(t1, m["t1_ms"], device_ms(lambda: t1mod.conv3d_dslice_v2(*call, relu=True), 5), plain_ms,
                        m["cudnn_conv_ms"], m["flops"], m["bytes"], n, chain_ms=m["chain_ms"])
            else:
                add(t1, {**m, "ms": m["t1_ms"], "library_ms": m["cudnn_conv_ms"]}, plain_ms, n)
            del inp, call
            torch.cuda.empty_cache()
    for k, row in rows.items():
        if row["launches"] == 0 or row.get("f32_route", {}).get("launches", 1) == 0:
            fail(f"{k} was not launched by its tool's measurement")
    return rows


def check_results(torch, res, b, h, w, bins=None):
    """Shapes and finiteness of an eval result at batch b, h x w: under the
    fused regression (`bins` None) `prob_depth` must be None, else
    [b, 1, bins, h, w]."""
    shapes = {"pred_depth": (b, 1, h, w), "pred_normal": (b, 1, h, w, 3), "ref_feature": (b, h // 4, w // 4)}
    if bins is not None:
        shapes["prob_depth"] = (b, 1, bins, h, w)
    elif res["prob_depth"] is not None:
        fail("prob_depth must be None under the fused regression")
    for key, shape in shapes.items():
        t = res[key]
        if tuple(t.shape) != shape:
            fail(f"{key}: shape {tuple(t.shape)} != {shape}")
        if not bool(torch.isfinite(t.float()).all()):
            fail(f"{key}: non-finite values")


def serve_full_width(torch, config, sd, card, per_forward, label="serving"):
    """Phases 5 and 5b: 3 request batches of `config`'s serving forward,
    with the launch counts set to 0 just before and read just after, held
    to `per_forward` launches per forward of each kernel."""
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch

    pred = Predictor(config, state_dict=sd, device="cuda", dtype=torch.bfloat16)
    bins = None if config.model.get("fused_regression", False) else 4 * config.model.level
    batches = [bench_batch(B, H, W, seed=s) for s in range(3)]
    check_results(torch, pred(batches[0]), B, H, W, bins)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    smoke = timed(pred, batches, check=lambda res: check_results(torch, res, B, H, W, bins))
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), **{k: n * len(batches) for k, n in per_forward.items()}}
    print(f"{label} launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}: the {label} path did not run through every kernel")
    # 3 batches: a smoke reading only; the serving rate is profile_serving's,
    # over many more batches through the same `timed`
    print(json.dumps({f"{label}_smoke": {**smoke, "model": config.model_name, "batch": B, "hw": [H, W],
                                         "dtype": "bfloat16", "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                                         "card": card}}), flush=True)
    del pred
    torch.cuda.empty_cache()
    return launches


def serve_graphs_check(torch, config, sd, card, per_forward):
    """Phase 5c: `config`'s serving forward at 768x576, batch 4 (bf16 for
    `stereodpnet_plus`, f32 for `stereodpnet`, as the benchmark serves them),
    its front stages replayed from CUDA graphs, against the same weights'
    eager forward (the Predictor's graphs closed). Six calls on four request
    batches: the first eager, the second captures, each later one replays.
    Every answer equals the eager one bit for bit (a replay runs the eager
    kernels); an output that differs is held to REL_TOL and named beside
    the difference between two eager runs of the same batch (the exact-f32
    forward is not bitwise reproducible run to run); an
    answer kept from one call is unchanged after every later call and
    shares no storage with a graph's buffer; `serve.graph_replays` grows by
    the model's number of `graph_stages` a call from the third call on; the
    launches per forward are `per_forward`."""
    from torch.utils._pytree import tree_flatten

    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch
    from dualpixelface_tpu_torch.utils import profiling

    dtype = torch.bfloat16 if config.model.get("fused_regression", False) else torch.float32
    dname = str(dtype).split(".")[-1]
    pred = Predictor(config, state_dict=sd, device="cuda", dtype=dtype)
    eager = Predictor(config, state_dict=sd, device="cuda", dtype=dtype)
    if pred.graphs is None:
        fail(f"phase 5c: {config.model_name} on the card has no graphs")
    eager.graphs.close()
    batches = [bench_batch(B, H, W, seed=s) for s in range(4)]
    kept, notes, replays = [], [], []
    for i, batch in enumerate(batches + batches[:2]):
        before = profiling.counters().get("serve.graph_replays", 0)
        reset_launch_counts()
        got = pred(batch)
        torch.cuda.synchronize()
        replays.append(profiling.counters().get("serve.graph_replays", 0) - before)
        launches = {k: n for k, n in launch_counts().items() if n}
        if launches != {k: n for k, n in per_forward.items() if n}:
            fail(f"phase 5c: {config.model_name} call {i}: launches {launches} != {per_forward}")
        want, again = eager(batch), eager(batch)
        for key, v in want.items():
            if v is None or torch.equal(got[key], v):
                continue
            err = float((got[key].float() - v.float()).abs().max())
            noise = float((again[key].float() - v.float()).abs().max())
            tol = REL_TOL[dname] * max(1.0, float(v.float().abs().max()))
            notes.append(f"call {i} {key}: max |graphed - eager| {err:.3e}, two eager runs {noise:.3e} (tol {tol:.3e})")
            if not err <= tol:
                fail(f"phase 5c: {config.model_name} {notes[-1]}")
        kept.append((got, {k: None if v is None else v.clone() for k, v in got.items()}))
    if replays[2:] != [len(pred.model.graph_stages)] * (len(replays) - 2):
        fail(f"phase 5c: {config.model_name} serve.graph_replays per call {replays}")
    static = {t.untyped_storage().data_ptr() for e in pred.graphs.captured.values()
              for t in [*e.inputs, *tree_flatten(e.outputs)[0]]}
    for i, (got, clone) in enumerate(kept):
        for key, v in got.items():
            if v is not None and (not torch.equal(v, clone[key]) or v.untyped_storage().data_ptr() in static):
                fail(f"phase 5c: {config.model_name} call {i}'s {key} changed after a later call or aliases a graph buffer")
    line = {"serve_graphs": {"model": config.model_name, "dtype": dname, "batch": B, "hw": [H, W],
                             "calls": len(replays), "replays_per_call": replays,
                             "captured": len(pred.graphs.captured), "bitwise": not notes, "notes": notes,
                             "launches_per_forward": per_forward, "card": card}}
    print(json.dumps(line), flush=True)
    del pred, eager
    torch.cuda.empty_cache()
    return line


def check_against_cpu(torch, config, sd):
    """Phases 6 and 6b: `config`'s eval forward at 192x192, batch 1, f32,
    the card (kernels) against the CPU (plain versions)."""
    from dualpixelface_tpu_torch.serve import Predictor, bench_batch

    batch = bench_batch(1, 192, 192, seed=7)
    gpu = Predictor(config, state_dict=sd, device="cuda", dtype=torch.float32)(batch)
    cpu = Predictor(config, state_dict=sd, device="cpu", dtype=torch.float32)(batch)
    bins = None if config.model.get("fused_regression", False) else 4 * config.model.level
    check_results(torch, gpu, 1, 192, 192, bins)
    d_err = float((gpu["pred_depth"].cpu() - cpu["pred_depth"]).abs().max())
    n_diff = (gpu["pred_normal"].cpu() - cpu["pred_normal"]).abs()
    n_share = float((n_diff <= 1e-3).float().mean())
    n_mean = float(n_diff.mean())
    print(f"192x192 f32 {config.model_name} card vs CPU: depth max_abs_err {d_err:.3e} (tol 1e-2); normals within 1e-3: "
          f"{n_share:.5f} (tol >= 0.995), mean abs err {n_mean:.3e} (tol 1e-3)", flush=True)
    # depth: f32 sums in another order through ~60 layers, then a softmax
    # over 32 bins; normals: a pixel whose disparity sits at a plane boundary
    # may pick the other sample_with_sort window, so a small share may differ
    if not (d_err <= 1e-2 and n_share >= 0.995 and n_mean <= 1e-3):
        fail(f"the card's {config.model_name} forward disagrees with the CPU forward at 192x192")


def train_full_width(torch, sd, card, cell="stereodpnet_plus", overrides=None):
    """Phases 7, 7b and 14b: 3 train steps in train cell `cell` of
    `profile_train.CELLS` (batch 2 at 768x576 under the bf16 policy:
    `profile_train.TRAIN_CELL`'s run keys), its model keys overridden by
    `overrides` where given, with the launch counts set to 0 just before
    and read just after."""
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.ops.precision import resolve_policy
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.profile_train import CELLS, TRAIN_CELL, cell_config, train_batch
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step

    if overrides:
        model, over = CELLS[cell]
        config = load_config(model, model_overrides={**over, **overrides}, run_overrides=TRAIN_CELL)
    else:
        config = cell_config(cell)
    if (resolve_policy(config), config.batch_size) != (torch.bfloat16, TB):
        fail(f"the train cell's run keys give {resolve_policy(config)}, batch {config.batch_size}")
    state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device="cuda")
    step = make_train_step(state.model, loss_selector(config), resolve_policy(config))
    batches = [train_batch(TB, H, W, seed=s) for s in range(3)]

    def check(losses):
        if set(losses) != {"smoothL1_loss", "cosine_loss", "final_loss"}:
            fail(f"train step losses {sorted(losses)}")
        for k, v in losses.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"train step {k} is not finite: {v}")

    check(step(state, train_batch(TB, H, W, seed=3))[1])  # warm-up (cuDNN plans, allocator)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    smoke = timed(lambda b: step(state, b)[1], batches, check=check)
    launches = launch_counts()
    per_step = {"K1": 2, "K2": 2, "K3": 3, "K4": 3, "K5": 2}
    want = {**dict.fromkeys(launches, 0), **{k: n * len(batches) for k, n in per_step.items()}}
    print(f"train cell {cell} launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"launch counts {launches} != {want}: the {cell} train path did not run through every kernel")
    masters = [p for g in state.optimizer.param_groups for p in g["params"]]
    params = list(state.model.parameters())
    if len(params) != len(masters) or any(p is not q or p.dtype != torch.float32 for p, q in zip(params, masters)):
        fail("the model's parameters are no longer the optimizer's f32 masters after the bf16 steps")
    moved = sum(int(not torch.equal(p.detach(), before[n])) for n, p in state.model.named_parameters())
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameter tensors moved in 3 train steps")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"train_smoke": {**smoke, "cell": cell, "overrides": overrides or {}, "model": config.model_name,
                                      "batch": TB, "hw": [H, W],
                                      "dtype": "bfloat16",
                                      "peak_memory_gb": peak, "params_moved": moved, "params": len(before),
                                      "card": card}}), flush=True)
    del state, step, before
    torch.cuda.empty_cache()
    return launches


def kink_log(torch):
    """A torch function mode that records, in call order, each decision of
    a step that switches its gradient: the side of 0 of every ReLU input,
    every `torch.where` condition (PReLU, LeakyReLU, the losses' branches),
    every floor (the ANM's plane window; the deform convs' sampling
    positions, as the floor of their offsets, from `watch(model)`), and the
    operand every elementwise maximum / minimum takes (the offset clamp,
    whose bound sets the aperture's 0.5, the cosine clip, the ASM's
    softmax). Calls from the kernels' plain versions (the CPU run) are left
    out: on the card those decisions are made inside the kernels."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    kernels_dir = str(ROOT / "dualpixelface_tpu_torch" / "ops" / "kernels")

    def in_kernel_wrapper():
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.startswith(kernels_dir):
                return True
            f = f.f_back
        return False

    class KinkLog(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.decisions = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.relu, F.relu, torch.Tensor.relu):
                d = args[0] > 0
            elif func is torch.where and len(args) == 3:
                d = args[0]
            elif func in (torch.floor, torch.Tensor.floor):
                d = out
            elif func in (torch.maximum, torch.minimum):
                d = torch.sign(args[0] - args[1])
            else:
                return out
            if not in_kernel_wrapper():
                self.decisions.append(d.detach().to("cpu", torch.float32))
            return out

        def watch(self, model):
            def hook(module, inputs, out):
                torch.floor(out[1])  # logged: the sampling positions' floors

            return [model.normal_estimator.get_submodule(f"deform_conv{i}").register_forward_hook(hook)
                    for i in (1, 2)]

    return KinkLog()


# phase 8: the views' seeds tried in order (1004 is the CPU test's point
# against JAX, tests/test_torch_train.py)
CPU_POINTS = (1004, 1008, 1009, 1000, 1002, 1007)
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def train_against_cpu(torch):
    """Phase 8: one f32 train step of batch 2 at 32x32 on the card against
    the same step on the CPU, from the committed plateau checkpoint on
    smooth views, the point tests/test_torch_train.py holds the CPU step
    against JAX at (why that point, in its fixture's docstring).

    A kink whose input lies within f32 rounding of its switch point can
    take one side on the card and the other on the CPU; the gradient then
    jumps by 1e-3 to 1e-1 upstream, whatever the precision, and that point
    tells nothing either way. So both runs log every kink decision
    (`kink_log`), and the phase holds the first point of CPU_POINTS where
    card and CPU decided alike everywhere: losses within 1e-4 of their
    value, each parameter's gradient within 1e-3 of its norm, and the two
    deform-conv biases (exact gradient zero: each feeds a batch-statistics
    BatchNorm) within 1e-6 of their weight's gradient norm on both. A point
    with differing decisions is reported and passed over; the phase fails
    if every point has them."""
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.ops.precision import exact_f32, resolve_policy
    from dualpixelface_tpu_torch.profile_train import smooth_views, train_batch
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step
    from dualpixelface_tpu_torch.weights import read_flax_msgpack, state_dict_from_jax

    config = load_config("stereodpnet_plus")  # the default run keys: the f32 policy
    exact_f32()  # the step is built by hand: the f32 setting the Trainer applies to it
    tree = read_flax_msgpack(ROOT / "tests" / "data" / "serving_plateau_192.msgpack")
    sd = state_dict_from_jax(tree["params"], tree["batch_stats"])

    def step(dev, batch):
        state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device=dev)
        log = kink_log(torch)
        hooks = log.watch(state.model)
        with log:
            state, losses = make_train_step(state.model, loss_selector(config), resolve_policy(config))(state, batch)
        for h in hooks:
            h.remove()
        return ({k: float(v) for k, v in losses.items()},
                {n: p.grad.detach().double().cpu() for n, p in state.model.named_parameters()}, log.decisions)

    for seed in CPU_POINTS:
        batch = {**train_batch(2, 32, 32), **smooth_views(2, 32, 32, seed)}
        (lg, gg, dg), (lc, gc, dc) = step("cuda", batch), step("cpu", batch)
        if len(dg) != len(dc) or any(a.shape != b.shape for a, b in zip(dg, dc)):
            fail(f"phase 8: the card and the CPU logged different kink sequences ({len(dg)} vs {len(dc)})")
        flips = sum(int((a != b).sum()) for a, b in zip(dg, dc))
        print(f"32x32 f32 train step, views seed {seed}: {len(dc)} kink sites, "
              f"{sum(a.numel() for a in dc)} decisions, {flips} differ between card and CPU", flush=True)
        if flips:
            continue
        loss_err = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
        rel = {n: float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc if n not in ZERO_GRAD}
        zero = max(float(max(gg[n].norm(), gc[n].norm()) / gc[n.replace(".bias", ".weight")].norm())
                   for n in ZERO_GRAD)
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        print(f"  card vs CPU: losses rel err {loss_err:.3e} (tol 1e-4); gradients per parameter: median "
              f"{sorted(rel.values())[len(rel) // 2]:.3e}, largest {worst} (tol 1e-3); zero-gradient biases "
              f"{zero:.3e} of their weight's (tol 1e-6)", flush=True)
        if not (loss_err <= 1e-4 and worst[0][1] <= 1e-3 and zero <= 1e-6):
            fail("the card's train step disagrees with the CPU's at 32x32")
        return
    fail(f"phase 8: card and CPU took another side of some kink at every point of {CPU_POINTS}")


# phase 10: the trainer's run config, cut to 2 train steps and 2 eval
# batches: batch 4 (train_faceDP's), images of 1024x768, whose committed
# soft crop (ratio 0.75, factor 96) is the reference's 768x576; 8 train
# samples, 6 test samples (the second eval batch padded by 2 rows).
TRAINER_CONFIG = "train_synthetic_stereodpnet_plus"
TRAINER_DATA = {"height": 1024, "width": 768, "train_samples": 8, "test_samples": 6}
TRAIN_STEP_LAUNCHES = {"K1": 2, "K2": 2, "K3": 3, "K4": 3, "K5": 2}
EVAL_LAUNCHES = {"K1": 2, "K3": 1, "K5": 2}
# each kernel's entry functions on the card (both routes), for its device
# time in a train step
KERNEL_FUNCS = {"K1": ("deform_fwd_3xtf32_kernel", "deform_fwd_tc_kernel"),
                "K2": ("deform_bwd_3xtf32_kernel", "deform_bwd_tc_kernel", "reduce_gw_kernel", "cast_depad_kernel"),
                "K3": ("fsam_fwd_kernel",), "K4": ("fsam_bwd_kernel",),
                "K5": ("conv3d_3xtf32_kernel", "conv3d_tc_kernel")}


class TimedPipeline:
    """A trainer's pipeline that records the seconds its consumer waited
    for each batch, and each batch's image shape and real rows."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.wait = 0.0
        self.shapes: set = set()
        self.valid: list = []
        self.last = None

    def set_epoch(self, epoch):
        self.pipe.set_epoch(epoch)

    def __len__(self):
        return len(self.pipe)

    def __iter__(self):
        it = iter(self.pipe)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait += time.perf_counter() - t
            self.shapes.add(tuple(batch["left"].shape))
            self.valid.append(int(batch["_valid"].sum()))
            self.last = batch
            yield batch


def kernel_step_profile(torch, step) -> dict:
    """torch.profiler over one call of `step` after a warm-up call: the
    device ms of each kernel K1-K5 (its entry functions), the device's busy
    ms and the wall ms."""
    from dualpixelface_tpu_torch.tools import device_busy_us

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("phase 10: the profiler recorded no device activity in a train step")
    per_kernel = {}
    for k, funcs in KERNEL_FUNCS.items():
        pattern = re.compile(r"\b(" + "|".join(funcs) + r")\b")
        per_kernel[k] = sum(e.time_range.end - e.time_range.start for e in events if pattern.search(e.name)) / 1e3
    return {"kernels_ms": per_kernel, "kernels_sum_ms": sum(per_kernel.values()),
            "device_busy_ms": device_busy_us(events) / 1e3, "wall_ms": wall_ms}


def trainer_option(root, workspace, overrides=None, load_model=None):
    """Phase 10's cut of TRAINER_CONFIG under `root` (a copy of configs/):
    one epoch of global batch TRAINER_BATCH on TRAINER_DATA."""
    from dualpixelface_tpu_torch.config import Configuration

    cfg = Configuration(TRAINER_CONFIG, workspace, load_model=load_model, root=root,
                        overrides={"epoch": 1, "batch_size": TRAINER_BATCH, **(overrides or {})})
    cfg.data["dataset"].update(TRAINER_DATA)
    return cfg.get_config()


def record_steps(torch, trainer, sync=False):
    """Wrap the train step `trainer.init_state` makes so that each call's
    losses land in the returned list (the device tensors; with `sync`, also
    each step's wall seconds and its state's digest)."""
    from dualpixelface_tpu_torch import parallel

    record = {"losses": [], "wall_s": [], "digests": []}
    init_state = trainer.init_state

    def init_and_wrap(steps_per_epoch):
        state = init_state(steps_per_epoch)
        record["init"] = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        step = trainer.train_step

        def recorded(state, batch, mark=None):
            t0 = time.perf_counter()
            out = step(state, batch, mark)
            record["losses"].append(out[1])
            if sync:
                torch.cuda.synchronize()
                record["wall_s"].append(time.perf_counter() - t0)
                record["digests"].append(parallel.state_digest(out[0].model))
            return out

        trainer.train_step = recorded
        return state

    trainer.init_state = init_and_wrap
    return record


def trainer_full_width(torch, card):
    """Phase 10: `Trainer.fit` then `test()` of the run config
    TRAINER_CONFIG (f32, Adam, 2 DataLoader workers, pinned memory, as
    committed) at 768x576 crops, batch 4, on SyntheticDP cut to 2 train
    steps and 2 eval batches (TRAINER_DATA), in a workspace under a copy of
    configs/ in build/; the launch counts set to 0 just before `fit` and
    before `test`, and read just after each. Then a fresh trainer in test
    mode restoring the epoch's checkpoint (`load_model`) must give the same
    metric aggregates to rtol 1e-4, and one more train step is profiled for
    the kernels' device time. Returns the phase's counts (fit + test) and
    phase 11's reference: each step's losses, the state after `fit` and
    the test tables."""
    import shutil
    import tempfile

    from dualpixelface_tpu_torch.data.pipeline import numeric_batch
    from dualpixelface_tpu_torch.data.preprocess import native
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.ops.precision import resolve_policy
    from dualpixelface_tpu_torch.train.trainer import Trainer

    # the loaders' host preprocessing: native/libdphost.so where `make -C
    # native` has built it (it needs OpenMP), else the numpy chain
    host_path = "native" if native.available() else "numpy"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase10_", dir=ROOT / "build"))
    try:
        shutil.copytree(ROOT / "configs", tmp / "configs")

        def option(overrides=None, load_model=None):
            return trainer_option(tmp, "phase10", overrides, load_model)

        opt = option()
        if resolve_policy(opt) != torch.float32 or opt.optim != "adam":
            fail(f"phase 10: the run config gives {resolve_policy(opt)}, {opt.optim}; f32 and adam are committed")
        # torch's defaults (cuDNN's f32 convolutions in TF32), as a fresh
        # process has them: the f32 Trainer must turn both flags off itself
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = TORCH_TF32_DEFAULTS
        trainer = Trainer(opt)  # the card: CUDA is the default
        if tf32_flags(torch) != (False, False):
            fail(f"phase 10: TF32 flags (cudnn, matmul) read {tf32_flags(torch)} after the f32 Trainer; "
                 "an f32 run must turn both off")
        print(f"phase 10: TF32 flags after the f32 Trainer {tf32_flags(torch)}", flush=True)
        steps_record = record_steps(torch, trainer)
        pipes = []
        make_pipe = trainer._pipeline

        def timed_pipeline(training):
            pipes.append(TimedPipeline(make_pipe(training)))
            return pipes[-1]

        trainer._pipeline = timed_pipeline
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        reference = {"losses": [{k: float(v) for k, v in d.items()} for d in steps_record["losses"]],
                     "init": steps_record["init"],
                     "state": {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}}
        reset_launch_counts()
        t0 = time.perf_counter()
        agg = trainer.test()
        test_s = time.perf_counter() - t0
        test_launches = launch_counts()

        steps = TRAINER_DATA["train_samples"] // TRAINER_BATCH
        batches = -(-TRAINER_DATA["test_samples"] // TRAINER_BATCH)
        for label, got, per, n in (("fit", fit_launches, TRAIN_STEP_LAUNCHES, steps),
                                   ("test", test_launches, EVAL_LAUNCHES, batches)):
            want = {**dict.fromkeys(got, 0), **{k: c * n for k, c in per.items()}}
            print(f"trainer {label} launches {got} (expected {want})", flush=True)
            if got != want:
                fail(f"phase 10: {label} launch counts {got} != {want}: the trainer did not run through every kernel")
        crop = (TRAINER_BATCH, H, W, 3)
        if [p.shapes for p in pipes] != [{crop}, {crop}] or pipes[1].valid != [4, 2] or trainer.state.step != steps:
            fail(f"phase 10: batches {[p.shapes for p in pipes]}, eval rows {pipes[1].valid}, "
                 f"steps {trainer.state.step}; expected {crop} crops, rows [4, 2], {steps} steps")
        records = [json.loads(line) for line in (Path(opt.output_path) / "metrics.jsonl").read_text().splitlines()]
        ckpts = sorted(p.name for p in Path(opt.ckpt_path).iterdir())
        losses = {k: v for k, v in records[0].items() if k.endswith("_loss")}
        if [r["mode"] for r in records] != ["train", "test"] or ckpts != ["checkpoint_00.pt"] or \
                len(losses) != 3 or not all(math.isfinite(v) for v in losses.values()):
            fail(f"phase 10: records {records}, checkpoints {ckpts}")

        restored = Trainer(option({"mode": "test"}, load_model=str(Path(opt.ckpt_path) / "checkpoint_00.pt")))
        agg2 = restored.test()
        worst = max(abs(agg2[m][k] - v) / max(abs(v), 1e-30) for m, d in agg.items() for k, v in d.items())
        print(f"restored checkpoint vs trainer: metric aggregates largest rel diff {worst:.3e} (tol 1e-4)", flush=True)
        if set(agg2) != set(agg) or worst > 1e-4:
            fail("phase 10: the restored checkpoint's metrics differ from the trainer's")
        del restored

        batch = {k: v for k, v in numeric_batch(pipes[0].last).items() if k != "_valid"}
        profile = kernel_step_profile(torch, lambda: trainer.train_step(trainer.state, trainer._to_device(batch)))
        print(json.dumps({"trainer_smoke": {
            "config": TRAINER_CONFIG, "batch": TRAINER_BATCH, "crop": [H, W], "precision": "float32",
            "steps": steps, "fit_s": fit_s, "steps_per_s": steps / fit_s, "dataloader_wait_s": pipes[0].wait,
            "dataloader_wait_share": pipes[0].wait / fit_s, "test_s": test_s, "test_wait_s": pipes[1].wait,
            "peak_memory_gb": peak, "workers": opt.workers, "pin_memory": opt.pin_memory,
            "host_preprocessing": host_path, "losses": losses, "train_step_profile": profile, "card": card}}),
            flush=True)
        del trainer
        torch.cuda.empty_cache()
        reference.update(agg=agg, fit_s=fit_s, peak_memory_gb=peak)
        return {k: fit_launches[k] + test_launches[k] for k in fit_launches}, reference
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cli(label: str, config: str, model: str, workspace: str, batch: int, steps, card: str,
            load_model: str | None = None) -> dict:
    """`python -m dualpixelface_tpu_torch.main --config <config> --workspace
    <workspace> [--load_model <load_model>]` as a user calls it, in a
    subprocess under a timeout. Checks rc 0, the train record (`steps`
    steps, a finite loss) and the test record, the epoch's checkpoint
    (with `steps` None, a test-mode run: the test record alone, every entry
    finite but absolute_dp's rmse_log, the log of depths that a model of
    seeded weights may make negative, and no checkpoint), then removes the
    workspace it made. Where gcd(batch, cards) > 1 the CLI runs that many
    ranks through `parallel.spawn`, one a card over nccl, and must print
    so."""
    import shutil

    import torch

    ws = ROOT / "workspace" / model / workspace
    if ws.exists():
        fail(f"phase {label}: {ws} exists already; it is not this run's to remove")
    made = [d for d in (ROOT / "workspace", ws.parent) if not d.exists()]
    try:
        t0 = time.perf_counter()
        extra = ["--load_model", load_model] if load_model else []
        out = subprocess.run([sys.executable, "-m", "dualpixelface_tpu_torch.main", "--config", config,
                              "--workspace", workspace, *extra], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"phase {label}: the CLI exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        cards = torch.cuda.device_count()
        ranks = math.gcd(batch, cards)
        spawned = f"parallel.spawn: {ranks} ranks on cuda ({cards} cards), backend nccl"
        if ranks > 1 and spawned not in out.stdout:
            fail(f"phase {label}: on {cards} cards the CLI did not print '{spawned}':\n{out.stdout[-2000:]}")
        records = [json.loads(line) for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
        ckpts = sorted(p.name for p in (ws / "checkpoints").iterdir())
        if steps is None:
            train = None
            test = records[0] if records else {}
            if [r["mode"] for r in records] != ["test"] or ckpts or not all(
                    math.isfinite(v) for k, v in test.items() if isinstance(v, float) and k != "absolute_dp/rmse_log"):
                fail(f"phase {label}: records {records}, checkpoints {ckpts}")
        else:
            train = records[0] if records else {}
            if [r["mode"] for r in records] != ["train", "test"] or ckpts != ["checkpoint_00.pt"] or \
                    train.get("steps") != float(steps) or not math.isfinite(train.get("final_loss", math.nan)):
                fail(f"phase {label}: records {records}, checkpoints {ckpts}")
            test = records[1]
        summary = {"config": Path(config).name, "model": model, "rc": out.returncode, "cli_s": cli_s,
                   "ranks": ranks, "load_model": load_model, "train_record": train, "test_record": test,
                   "card": card}
        print(json.dumps({"cli_smoke": summary}), flush=True)
        return summary
    finally:
        shutil.rmtree(ws, ignore_errors=True)
        for d in reversed(made):
            if d.exists() and not any(d.iterdir()):
                d.rmdir()


def cli_subprocess(card):
    """Phase 10b: the CLI (`run_cli`) on <tmp>/configs/smoke.json, which is
    TRAINER_CONFIG with epoch 1 (8 steps of batch 8 on its own 384x288
    data, 288x192 crops, then a test pass), workspace `chip_smoke`."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="phase10b_", dir=ROOT / "build"))
    try:
        run = json.loads((ROOT / "configs" / f"{TRAINER_CONFIG}.json").read_text())
        run["epoch"] = 1
        (tmp / "configs").mkdir()
        (tmp / "configs" / "smoke.json").write_text(json.dumps(run))
        return run_cli("10b", str(tmp / "configs" / "smoke.json"), "stereodpnet_plus", "chip_smoke",
                       run["batch_size"], 8, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 11: phase 10's run (trainer_option: global batch 4, 768x576, f32,
# Adam, 2 train steps, 2 eval batches, the second padded) on DDP_RANKS
# ranks, 2 rows a rank, held to phase 10's one process. The two runs do the
# same f32 arithmetic in another order: K2's gx by f32 atomics (which alone
# differ from run to run), BatchNorm's moments as per-rank sums joined by
# the all-reduce, the masked means' global counts, the gradient as per-rank
# backwards summed by the all-reduce, and cuDNN's convolutions at batch 2
# instead of 4. At the seeded init a kink's input can lie within that
# rounding of its switch point, and Adam's first steps move each weight by
# about lr * sign(g), so a flipped sign moves a weight by up to 2 lr. The
# four numbers (`ddp_differences`): each step's global losses, relative;
# the parameters' moves from the init (without the deform convs' biases,
# whose exact gradient is zero) against the update's norm; each BatchNorm
# buffer against its norm; each test-table entry against max(1, |phase
# 10's|). `python3 -m dualpixelface_tpu_torch.tools.ddp_tolerance` read
# them on an H100 80GB HBM3 at 700 W. Noise (phase 10 against itself, phase
# 11 against phase 10 and against itself, 8 readings with chip_smoke's):
# loss <= 3.8e-5, update <= 5.3e-2, buffer <= 3.4e-4, table <= 3.2e-3.
# Faults planted in the ranks: per-rank BatchNorm statistics 5.5e-2, 0.82,
# 0.38, 0.24; BatchNorm moments without their gradient's all-reduce 1.2e-2,
# 0.67, 0.16, 4.4e-2; a per-rank masked mean 4.6e-4, 5.8e-2, 4.8e-4,
# 9.9e-4, caught by the loss alone (SyntheticDP's masks hold similar counts,
# so its gradient moves within the noise; tests/test_torch_parallel.py's
# 60% / 100% masks catch that). Each bound sits between the noise and the
# smallest fault that clears it, about the geometric mean. The ranks must
# agree bit for bit after every step; tests/test_torch_parallel.py holds the
# same reductions to 1e-5 at a well-conditioned point on the CPU.
DDP_RANKS = 2
DDP_TOL = {"loss": 1.5e-4, "update": 0.2, "buffer": 1e-2, "table": 1e-2}
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def ddp_rank(root: str) -> dict:
    """One rank of phase 11, in a process `parallel.spawn` started: the
    Trainer on phase 10's cut under `root`, this rank's 2 rows of each
    global batch; the launch counts set to 0 just before `fit` and before
    `test`, and read just after each; each step's losses, wall seconds and
    state digest; the peak memory; rank 0's state after `fit`."""
    import torch

    from dualpixelface_tpu_torch import parallel
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.train.trainer import Trainer

    world = parallel.world()
    trainer = Trainer(trainer_option(Path(root), "phase11"))
    record = record_steps(torch, trainer, sync=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()} if world.main else None
    reset_launch_counts()
    agg = trainer.test()
    test_launches = launch_counts()
    return {"rank": world.rank, "backend": world.backend, "device": str(trainer.device),
            "launches_fit": fit_launches, "launches_test": test_launches, "peak_memory_gb": peak,
            "fit_s": fit_s, "step_wall_s": record["wall_s"], "digests": record["digests"],
            "losses": [{k: float(v) for k, v in d.items()} for d in record["losses"]], "state": state, "agg": agg}


def ddp_differences(reference: dict, rank0: dict) -> dict:
    """Phase 11's rank 0 against phase 10, in DDP_TOL's terms: the largest
    relative loss difference over the steps, the parameters' update
    difference over the update's norm (and the worst parameter's, for the
    record), the worst BatchNorm buffer's difference over its norm (a
    differing step count counts 1), the worst test-table entry's."""
    init, one, two = reference["init"], reference["state"], rank0["state"]
    losses = [abs(b[k] - a[k]) / abs(a[k]) for a, b in zip(reference["losses"], rank0["losses"]) for k in a]
    num = den = 0.0
    each, buffer = {}, {}
    for name, v in one.items():
        if name.endswith(("running_mean", "running_var")):
            buffer[name] = float((two[name] - v).norm() / v.norm())
        elif name.endswith("num_batches_tracked"):
            buffer[name] = float(two[name] != v)
        elif name not in ZERO_GRAD:
            d1, d2 = v - init[name], two[name] - init[name]
            num += float((d2 - d1).square().sum())
            den += float(d1.square().sum())
            each[name] = float((d2 - d1).norm() / d1.norm())
    table = max(abs(rank0["agg"][m][k] - v) / max(1.0, abs(v)) for m, d in reference["agg"].items() for k, v in d.items())
    worst, worst_buffer = max(each, key=each.get), max(buffer, key=buffer.get)
    return {"loss": max(losses) if len(losses) == len(reference["losses"]) * 3 else math.inf,
            "update": (num / den) ** 0.5, "buffer": buffer[worst_buffer], "table": table,
            "worst_update": [worst, each[worst]], "worst_buffer": [worst_buffer, buffer[worst_buffer]]}


def ddp_phase(torch, card, reference):
    """Phase 11: phase 10's run on DDP_RANKS ranks through `parallel.spawn`
    and the Trainer: on the one card over gloo, and, where the machine has
    two cards or more, on two cards over nccl. Each rank must launch K1-K5
    as phase 10 does (the same path at half the batch), every rank must
    hold the same state after each step, rank 0 alone writes the records,
    the log and the checkpoint, and rank 0's losses, state and tables are
    held to phase 10's at DDP_TOL. Returns each run's per-rank summaries."""
    import shutil
    import tempfile

    from dualpixelface_tpu_torch import parallel

    steps = TRAINER_DATA["train_samples"] // TRAINER_BATCH
    batches = -(-TRAINER_DATA["test_samples"] // TRAINER_BATCH)
    runs = {}
    for cards in (1, 2):
        if torch.cuda.device_count() < cards:
            continue
        tmp = Path(tempfile.mkdtemp(prefix="phase11_", dir=ROOT / "build"))
        try:
            shutil.copytree(ROOT / "configs", tmp / "configs")
            t0 = time.perf_counter()
            ranks = parallel.spawn(ddp_rank, DDP_RANKS, "cuda", args=(str(tmp),), cards=cards)
            wall = time.perf_counter() - t0
            ws = tmp / "workspace" / "stereodpnet_plus" / "phase11"
            records = [json.loads(line)["mode"] for line in (ws / "output" / "metrics.jsonl").read_text().splitlines()]
            logs = (ws / "output" / "log_text.txt").read_text().splitlines()
            ckpts = sorted(p.name for p in (ws / "checkpoints").iterdir())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        label = f"{ranks[0]['backend']}, {cards} card(s)"
        for r in ranks:
            print(json.dumps({"ddp_rank": {k: v for k, v in r.items() if k not in ("state", "agg", "digests")},
                              "run": label, "card": card}), flush=True)
            for kind, per, n in (("fit", TRAIN_STEP_LAUNCHES, steps), ("test", EVAL_LAUNCHES, batches)):
                got = r[f"launches_{kind}"]
                want = {**dict.fromkeys(got, 0), **{k: c * n for k, c in per.items()}}
                if got != want:
                    fail(f"phase 11 ({label}): rank {r['rank']} {kind} launches {got} != {want}")
        if not all(r["digests"] == ranks[0]["digests"] and len(r["digests"]) == steps for r in ranks):
            fail(f"phase 11 ({label}): the ranks' states differ after some step: {[r['digests'] for r in ranks]}")
        if records != ["train", "test"] or len(logs) != 1 or ckpts != ["checkpoint_00.pt"]:
            fail(f"phase 11 ({label}): rank 0 alone must write: records {records}, {len(logs)} log lines, "
                 f"checkpoints {ckpts}")
        if not all(r["agg"] == ranks[0]["agg"] for r in ranks):
            fail(f"phase 11 ({label}): the ranks return different test tables")
        diff = ddp_differences(reference, ranks[0])
        print(json.dumps({"ddp_vs_one_process": diff, "tolerances": DDP_TOL, "run": label,
                          "spawn_wall_s": wall, "card": card}), flush=True)
        if not all(diff[k] <= tol for k, tol in DDP_TOL.items()) or set(ranks[0]["agg"]) != set(reference["agg"]):
            fail(f"phase 11 ({label}): the {DDP_RANKS}-rank run differs from phase 10's beyond DDP_TOL: {diff}")
        runs[label] = [{k: r[k] for k in ("backend", "device", "peak_memory_gb", "step_wall_s")}
                       | {"launches": {k: r["launches_fit"][k] + r["launches_test"][k] for k in r["launches_fit"]}}
                       for r in ranks]
    return runs


# phase 12: the zoo at its committed widths (stereonet k 3; psmnet and nnet
# inplanes 32, level 8; dpnet; bts ResNet-50 at bts_size 256) through each
# model's FaceDP run config (f32, Adam, flip_lr), at 768x576.
ZOO = {"stereonet": "train_faceDP_stereonet", "psmnet": "train_faceDP_psmnet", "nnet": "train_faceDP_nnet",
       "dpnet": "train_faceDP_dpnet", "bts": "train_faceDP_bts"}
ZOO_EVAL_BATCH = 4
# 12c's size: 192x192 as phase 6 for stereonet, and for dpnet (a multiple
# of 96, where its five heads land on the full resolution) and bts (of
# 32); psmnet's and nnet's SPP pools take windows of up to 2C = 64
# quarter-resolution pixels, so 256x256 is their smallest square
ZOO_CPU_HW = {"stereonet": 192, "psmnet": 256, "nnet": 256, "dpnet": 192, "bts": 192}
# the models that read the center view (the others the dual-pixel pair)
ZOO_CENTER = ("bts",)
# parameters whose exact gradient is zero: conv3d_alone's bias adds one
# constant to every plane's logit, which the soft-argmin cancels; the
# tower's last bias cancels in ref - target on the valid rows. Their
# update is Adam's first step on rounding, which may be exactly 0.
ZOO_ZERO_GRAD = {"stereonet": ("conv3d_alone.bias", "feature_extraction.lastconv.bias")}


def run_option(name: str):
    """The merged committed run config `name`, without a workspace."""
    from dualpixelface_tpu_torch.config import Configuration

    return Configuration(name, make_workspace=False).get_config()


def zoo_option(model: str):
    return run_option(ZOO[model])


# dpnet's eval forward at zoo_state_dict's random running statistics grows
# to ~1.5e4 through its 13 residual stages (each adds its skip, and eval
# BatchNorms with those statistics do not renormalise), where f32 alone
# leaves 2.9e-2 of absolute error (the CPU against f64 at 192x192, 12c's
# size), beyond 12c's 1e-2: its running statistics are set to a train-mode
# forward's batch statistics instead, as a trained model's match its
# activations (`zoo_state_dict`)
ZOO_CALIBRATED = ("dpnet",)


def zoo_state_dict(config, seed: int = 0) -> dict:
    """Seeded weights that keep the activations O(1), the recipe of the CPU
    tests (tests/torch_zoo.py): conv weights N(0, 1) / sqrt(fan in),
    BatchNorm scales and running variances U(0.5, 1.5), biases and running
    means 0.1 N(0, 1). The seeded init (He-normal, BatchNorm at identity)
    grows psmnet's features to ~1e4 and saturates every soft-argmin. For
    the models of ZOO_CALIBRATED, each BatchNorm's running statistics are
    then its batch statistics in one train-mode forward (momentum 1) of
    `profile_train.train_batch(2, 192, 192)` on the CPU."""
    import torch

    from dualpixelface_tpu_torch.models import build_model
    from dualpixelface_tpu_torch.profile_train import train_batch
    from dualpixelface_tpu_torch.weights import load_state_dict

    gen = torch.Generator().manual_seed(seed)
    model = build_model(config, device="cpu", seed=seed)
    out = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            out[name] = t
        elif t.ndim > 1:
            out[name] = torch.randn(t.shape, generator=gen) / math.sqrt(t[0].numel())
        elif name.endswith("running_var") or (name.endswith("weight") and t.ndim == 1):
            out[name] = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            out[name] = 0.1 * torch.randn(t.shape, generator=gen)
    if config.model_name in ZOO_CALIBRATED:
        load_state_dict(model, out)
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.momentum = 1.0
        with torch.no_grad():
            model.train()({k: torch.as_tensor(v) for k, v in train_batch(2, 192, 192, seed=seed).items()})
        out = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def zoo_batch(model: str, b: int, h: int, w: int, seed: int = 0) -> dict:
    """A request batch of `serve.bench_batch`, with a random center view for
    the models of ZOO_CENTER."""
    import numpy as np

    from dualpixelface_tpu_torch.serve import bench_batch

    batch = bench_batch(b, h, w, seed=seed)
    if model in ZOO_CENTER:
        batch["center"] = np.random.default_rng(seed + 100).standard_normal((b, h, w, 3)).astype(np.float32)
    return batch


def zoo_shapes(model: str, config, b: int, h: int, w: int, train: bool = False) -> dict:
    """Every result key's shape at batch b, h x w: stereonet's coarse and
    refined depth and its 2^k planes at 1/2^k; psmnet's 1 head (3 in
    train mode) and nnet's 2, each with 4 * level bins at full resolution;
    dpnet's 5 heads and its first stage's channel max; bts's depth and its
    encoder's first skip's channel max."""
    if model == "dpnet":
        return {"pred_depth": (b, 5, h, w), "ref_feature": (b, (h - 5) // 2 + 1, (w - 5) // 2 + 1)}
    if model == "bts":
        return {"pred_depth": (b, 1, h, w), "ref_feature": (b, h // 2, w // 2)}
    if model == "stereonet":
        s = 2 ** int(config.model.k)
        return {"pred_depth": (b, 2, h, w), "prob_depth": (b, 1, s, h // s, w // s), "ref_feature": (b, h // s, w // s)}
    n = 2 if model == "nnet" else (3 if train else 1)
    shapes = {"pred_depth": (b, n, h, w), "prob_depth": (b, n, 4 * config.model.level, h, w),
              "ref_feature": (b, h // 4, w // 4)}
    if model == "nnet":
        shapes["pred_normal"] = (b, 1, h, w, 3)
    return shapes


def check_zoo_results(torch, model: str, res: dict, shapes: dict) -> None:
    if set(res) != set(shapes):
        fail(f"phase 12 {model}: result keys {sorted(res)} != {sorted(shapes)}")
    for key, shape in shapes.items():
        if tuple(res[key].shape) != shape:
            fail(f"phase 12 {model}: {key} shape {tuple(res[key].shape)} != {shape}")
        if not bool(torch.isfinite(res[key].float()).all()):
            fail(f"phase 12 {model}: {key} has non-finite values")


def zoo_serve(torch, model: str, sd: dict, card: str) -> dict:
    """Phase 12a: 3 request batches of 4 at 768x576 through
    `Predictor(dtype=float32)`: every key's shape, finiteness, the launch
    counts (all 0: the zoo calls the plain soft-argmin, as in JAX) set to 0
    just before and read just after, the peak memory, a smoke reading of
    pairs/s."""
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.serve import Predictor

    config = zoo_option(model)
    pred = Predictor(config, state_dict=sd, device="cuda", dtype=torch.float32)
    if tf32_flags(torch) != (False, False):
        fail(f"phase 12a: TF32 flags {tf32_flags(torch)} after an f32 Predictor")
    shapes = zoo_shapes(model, config, ZOO_EVAL_BATCH, H, W)
    batches = [zoo_batch(model, ZOO_EVAL_BATCH, H, W, seed=s) for s in range(3)]
    check_zoo_results(torch, model, pred(batches[0]), shapes)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    smoke = timed(pred, batches, check=lambda res: check_zoo_results(torch, model, res, shapes))
    launches = launch_counts()
    if any(launches.values()):
        fail(f"phase 12a {model}: launch counts {launches}; the zoo's path runs no kernel of K1-K5")
    print(json.dumps({"zoo_serving_smoke": {**smoke, "model": model, "batch": ZOO_EVAL_BATCH, "hw": [H, W],
                                            "dtype": "float32", "launches": launches,
                                            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                                            "card": card}}), flush=True)
    del pred
    torch.cuda.empty_cache()
    return launches


def zoo_train(torch, model: str, sd: dict, card: str, ckpt_dir=None) -> dict:
    """Phase 12b: 3 train steps at the run config's batch (stereonet 4, the
    others 2) at 768x576, f32, Adam, from the same seeded weights: finite
    losses, every parameter moved (but those of ZOO_ZERO_GRAD, reported),
    the launch counts all 0 (set to 0 just before, read just after), the
    peak memory, the step wall. With `ckpt_dir`, the state after the steps
    is written there through `train/checkpoint.py` (epoch 0)."""
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.ops.precision import exact_f32, resolve_policy
    from dualpixelface_tpu_torch.profile_serving import timed
    from dualpixelface_tpu_torch.profile_train import train_batch
    from dualpixelface_tpu_torch.train.state import create_train_state
    from dualpixelface_tpu_torch.train.steps import make_train_step

    config = zoo_option(model)
    b = int(config.batch_size)
    if resolve_policy(config) != torch.float32 or config.optim != "adam":
        fail(f"phase 12b {model}: the run config gives {resolve_policy(config)}, {config.optim}")
    exact_f32()  # the step is built by hand: the f32 setting the Trainer applies to it
    state = create_train_state(config, steps_per_epoch=100, state_dict=sd, device="cuda")
    step = make_train_step(state.model, loss_selector(config), torch.float32)
    names = {f"{n}_loss" for n in config.model.loss_type} | {"final_loss"}

    def check(losses):
        if set(losses) != names:
            fail(f"phase 12b {model}: losses {sorted(losses)} != {sorted(names)}")
        for k, v in losses.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"phase 12b {model}: {k} is not finite: {v}")

    check(step(state, train_batch(b, H, W, seed=3))[1])  # warm-up (cuDNN plans, allocator)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batches = [train_batch(b, H, W, seed=s) for s in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    smoke = timed(lambda bb: step(state, bb)[1], batches, check=check)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        fail(f"phase 12b {model}: launch counts {launches}; the zoo's path runs no kernel of K1-K5")
    still = sorted(n for n, p in state.model.named_parameters() if torch.equal(p.detach(), before[n]))
    if set(still) - set(ZOO_ZERO_GRAD.get(model, ())):
        fail(f"phase 12b {model}: parameters that did not move in 3 steps: {still}")
    print(json.dumps({"zoo_train_smoke": {**smoke, "model": model, "batch": b, "hw": [H, W], "dtype": "float32",
                                          "step_wall_s": smoke["latency_s"]["median"], "launches": launches,
                                          "peak_memory_gb": peak, "params": len(before), "unmoved": still,
                                          "card": card}}), flush=True)
    if ckpt_dir is not None:
        from dualpixelface_tpu_torch.train.checkpoint import save_checkpoint

        save_checkpoint(str(ckpt_dir), state, 0)
    del state, step, before
    torch.cuda.empty_cache()
    return launches


def zoo_against_cpu(torch, model: str, sd: dict) -> None:
    """Phase 12c: the same seeded weights' eval forward at ZOO_CPU_HW,
    batch 1, f32, the card (at the port's own TF32 setting, which the f32
    Predictor applies) against the CPU, at phase 6's tolerances: depth
    within 1e-2; nnet's normals within 1e-3 on 99.5% of the components and
    1e-3 on average. bts's depth is in millimetres, max_depth x a sigmoid
    floored at min_depth ([700, 1500]), not a disparity of a few units: it
    is held within 1e-4 of max_depth (0.15 mm), which is 1e-4 of the
    sigmoid, about what f32 keeps through ResNet-50 and the decoder's
    ~60 layers summed in another order (1e-2 would pass a sigmoid wrong in
    its fifth digit)."""
    from dualpixelface_tpu_torch.serve import Predictor

    config = zoo_option(model)
    hw = ZOO_CPU_HW[model]
    batch = zoo_batch(model, 1, hw, hw, seed=7)
    gpu = Predictor(config, state_dict=sd, device="cuda", dtype=torch.float32)(batch)
    cpu = Predictor(config, state_dict=sd, device="cpu", dtype=torch.float32)(batch)
    check_zoo_results(torch, model, gpu, zoo_shapes(model, config, 1, hw, hw))
    d_err = float((gpu["pred_depth"].cpu() - cpu["pred_depth"]).abs().max())
    tol = 1e-4 * float(config.model.max_depth) if model == "bts" else 1e-2
    line = f"{hw}x{hw} f32 {model} card vs CPU: depth max_abs_err {d_err:.3e} (tol {tol:.3g})"
    ok = d_err <= tol
    if model == "nnet":
        n_diff = (gpu["pred_normal"].cpu() - cpu["pred_normal"]).abs()
        n_share, n_mean = float((n_diff <= 1e-3).float().mean()), float(n_diff.mean())
        line += f"; normals within 1e-3: {n_share:.5f} (tol >= 0.995), mean abs err {n_mean:.3e} (tol 1e-3)"
        ok = ok and n_share >= 0.995 and n_mean <= 1e-3
    print(line, flush=True)
    if not ok:
        fail(f"phase 12c: the card's {model} forward disagrees with the CPU forward at {hw}x{hw}")


def zoo_cli(card: str) -> dict:
    """Phase 12d: `python -m dualpixelface_tpu_torch.main --config ci_smoke
    --workspace chip_smoke_zoo` (`run_cli`): the committed run config,
    stereonet on SyntheticDP, one epoch of batch 4, then a test pass."""
    config = run_option("ci_smoke")
    steps = int(config.dataset.train_samples) // int(config.batch_size)
    return run_cli("12d", "ci_smoke", "stereonet", "chip_smoke_zoo", int(config.batch_size), steps, card)


# 12d's FaceDP fixture for eval_faceDP_dpnet: 8 test samples (2 batches of
# 4) at the serving size, which config_test's center crop (ratio 1, factor
# 96) keeps whole
ZOO_EVAL_FIXTURE = {"n_train": 1, "n_test": 8, "height": H, "width": W}


def zoo_eval_cli(card: str, tmp: Path) -> dict:
    """Phase 12d, dpnet: the committed `eval_faceDP_dpnet` (test mode, batch
    4) through the CLI (`run_cli`, --load_model the checkpoint that
    12b wrote from dpnet's state under `tmp`), its dataset the FaceDP
    fixture ZOO_EVAL_FIXTURE written under `tmp`, named by a copy of the run
    config there; `tmp` is removed after."""
    import shutil

    from dualpixelface_tpu_torch.data.SyntheticDP.fixture import write_fixture_tree

    try:
        fixture = write_fixture_tree(tmp / "rcv", **ZOO_EVAL_FIXTURE)
        data = json.loads((ROOT / "dualpixelface_tpu_torch" / "data" / "FaceDP" / "config.json").read_text())
        (tmp / "facedp.json").write_text(json.dumps({**data, "path": str(fixture)}))
        run = json.loads((ROOT / "configs" / "eval_faceDP_dpnet.json").read_text())
        (tmp / "configs").mkdir()
        (tmp / "configs" / "eval_faceDP_dpnet.json").write_text(json.dumps({**run, "dataset_config": str(tmp / "facedp")}))
        return run_cli("12d", str(tmp / "configs" / "eval_faceDP_dpnet.json"), "dpnet", "chip_smoke_dpnet",
                       run["batch_size"], None, card, load_model=str(tmp / "ckpt" / "checkpoint_00.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def zoo_phase(torch, card: str, phase) -> dict:
    """Phase 12 (a-c per model, then d). Returns each model's K1-K5 launch
    counts, 12a's and 12b's summed (all 0)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase12d_", dir=ROOT / "build"))
    (tmp / "ckpt").mkdir()
    launches = {}
    for model in ZOO:
        sd = zoo_state_dict(zoo_option(model))
        serving = phase(f"12a {model}", zoo_serve, torch, model, sd, card)
        train = phase(f"12b {model}", zoo_train, torch, model, sd, card, tmp / "ckpt" if model == "dpnet" else None)
        phase(f"12c {model}", zoo_against_cpu, torch, model, sd)
        launches[model] = {k: serving[k] + train[k] for k in serving}
    phase("12d", zoo_cli, card)
    phase("12d dpnet", zoo_eval_cli, card, tmp)
    return launches


# phase 13: the last modules. 13a the multi-view training run
# (`fixture.write_multiview_run`: train_faceDP_dpnet with config_multi,
# use_multi, use_raw, views 1-3, the references' centre images, smoothL1 +
# folded; f32, Adam, batch 2 as committed; one epoch) on a FaceDP multi-view fixture
# of 1024x768 images, whose committed soft crop (ratio 0.75, factor 96) is
# 768x576: 2 view indices x 3 cameras = 6 train samples (3 steps), 1 x 3
# test samples (2 eval batches, the second padded by 1 row).
MULTIVIEW_FIXTURE = {"n_train": 2, "n_test": 1, "height": 1024, "width": 768, "cams": (1, 2, 3)}
MULTIVIEW_BATCH = 2
# 13b: the same run through the CLI on a fixture of the same samples at
# 384x256 (the committed soft crop gives 288x192, a multiple of 96), batch
# 3: its 6 samples in 2 steps
MULTIVIEW_CLI_HW = (384, 256)
MULTIVIEW_CLI_BATCH = 3
# 13a': one step at 96x96 (dpnet's heads land on the full resolution at
# multiples of 96), the card against the CPU. The folded loss takes the
# first head as a depth; where it lies near 0+ and still lands in a view, a
# pixel moves by f t / d^2 per unit of depth and the two devices' rounding
# moves samples across pixel boundaries (tests/test_torch_folded.py: the
# step's gradients then differ by up to 100%). As that test does, the first
# head's last BatchNorm bias is raised by MULTIVIEW_HEAD_SHIFT (depths
# ~5..15), the references move by up to 0.08 x that in x, and the PReLU
# slopes are U(0.85, 0.95). The gradients are held in f64 (the card's
# cuDNN and the CPU's sums in another order; ~60 BatchNorms in series
# amplify f64's 1e-16 by at most ~1e5 at these slopes: 1e-8 of the norm).
MULTIVIEW_HEAD_SHIFT = 10.0
MULTIVIEW_CPU_HW = 96
MULTIVIEW_F64_TOL = 1e-8
# 13c: the face mask tool at its size 512 on one 768x576 image; the logits
# to 1e-4 of the largest (f32 through ~20 convs and BatchNorms, sums in
# another order), the masks on at least 99.9% of the pixels alike
FACE_SIZE = 512
FACE_LOGIT_TOL = 1e-4
FACE_MASK_AGREEMENT = 0.999
# 13d: DeformConvPack2D at the ANM's 1/4 scale of 768x576, 64 channels,
# offsets ~N(0, 1). The output, the offsets and the weight's and bias's
# gradients are continuous in the sample positions: each within DCN_TOL of
# its largest entry (f32 sums of 4 corners x 9 taps x 64 channels, and of
# the 576 terms of the offset head, in another order). The gradients that
# pass through the offsets (x's, through the offset head too, and the
# offset head's) take each sample's derivative with respect to its
# position, which jumps where the sample crosses a pixel boundary: the two
# devices' offsets differ by ~1e-6, so of the 2.0M sample coordinates ~4
# lie across a boundary from each other, each moving the offset head's
# gradient by ~7e-4 of its norm. Those are held in norm, within
# DCN_JUMP_TOL.
DCN_SHAPE = (4, H // 4, W // 4, 64)
DCN_TOL = 1e-4
DCN_JUMP_TOL = 1e-2
DCN_THROUGH_OFFSETS = ("x", "conv_offset.weight", "conv_offset.bias")


def multiview_option(root: Path, **run):
    """The merged config of the multi-view run config that
    `fixture.write_multiview_run` wrote under `root`."""
    from dualpixelface_tpu_torch.config import Configuration

    return Configuration(str(root / "configs" / "train_faceDP_dpnet_multi.json"), root=root, **run).get_config()


def multiview_trainer(torch, card: str, tmp: Path) -> dict:
    """Phase 13a: `Trainer.fit` then `test()` of the multi-view run on the
    fixture under `tmp` (4 DataLoader workers, pinned memory, as
    committed), the launch
    counts set to 0 just before each and read just after (all 0: dpnet
    runs no kernel of K1-K5); 768x576 crops, 3 steps, eval rows [2, 1];
    every parameter moved; each step's folded loss finite and non-zero;
    the folded loss's forward ms per step (CUDA events around it), the
    steps per second, the synchronised step wall, the peak memory. Returns
    the launch counts, fit and test summed."""
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.ops.precision import resolve_policy
    from dualpixelface_tpu_torch.train.trainer import Trainer

    opt = multiview_option(tmp, workspace="phase13")
    if resolve_policy(opt) != torch.float32 or opt.optim != "adam" or opt.batch_size != MULTIVIEW_BATCH:
        fail(f"phase 13a: the run config gives {resolve_policy(opt)}, {opt.optim}, batch {opt.batch_size}")
    trainer = Trainer(opt)
    if tf32_flags(torch) != (False, False):
        fail(f"phase 13a: TF32 flags {tf32_flags(torch)} after the f32 Trainer")
    folded = [i for i, (name, _, _) in enumerate(trainer.loss_bank.entries) if name == "folded"]
    if len(folded) != 1:
        fail(f"phase 13a: losses {[e[0] for e in trainer.loss_bank.entries]}; the run takes smoothL1 + folded")
    name, lam, loss = trainer.loss_bank.entries[folded[0]]
    spans = []

    def timed_folded(results, batch, target_type="disp"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = loss(results, batch, target_type)
        end.record()
        spans.append((start, end))
        return out

    trainer.loss_bank.entries[folded[0]] = (name, lam, timed_folded)
    record = record_steps(torch, trainer, sync=True)
    pipes = []
    make_pipe = trainer._pipeline

    def timed_pipeline(training):
        pipes.append(TimedPipeline(make_pipe(training)))
        return pipes[-1]

    trainer._pipeline = timed_pipeline
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reset_launch_counts()
    trainer.test()
    test_launches = launch_counts()
    launches = {k: fit_launches[k] + test_launches[k] for k in fit_launches}
    if any(launches.values()):
        fail(f"phase 13a: launch counts {launches}; dpnet's multi-view path runs no kernel of K1-K5")

    steps = 3 * MULTIVIEW_FIXTURE["n_train"] // MULTIVIEW_BATCH
    crop = (MULTIVIEW_BATCH, H, W, 3)
    if [p.shapes for p in pipes] != [{crop}, {crop}] or pipes[1].valid != [2, 1] or trainer.state.step != steps:
        fail(f"phase 13a: batches {[p.shapes for p in pipes]}, eval rows {pipes[1].valid}, steps "
             f"{trainer.state.step}; expected {crop} crops, rows [2, 1], {steps} steps")
    last = pipes[0].last
    views = tuple(last["centers"].shape)
    if views[:2] != (MULTIVIEW_BATCH, 3) or tuple(last["Ps"].shape) != (MULTIVIEW_BATCH, 3, 4, 4):
        fail(f"phase 13a: reference views {views}, Ps {tuple(last['Ps'].shape)}; the run takes 3 views")
    losses = [{k: float(v) for k, v in d.items()} for d in record["losses"]]
    if len(losses) != steps or not all(math.isfinite(d[k]) for d in losses for k in d) or \
            not all(d["folded_loss"] != 0.0 for d in losses):
        fail(f"phase 13a: step losses {losses}")
    after = dict(trainer.state.model.named_parameters())
    still = sorted(n for n, p in after.items() if torch.equal(p.detach().cpu(), record["init"][n]))
    if still:
        fail(f"phase 13a: parameters that did not move in {steps} steps: {still}")
    records = [json.loads(line) for line in (Path(opt.output_path) / "metrics.jsonl").read_text().splitlines()]
    ckpts = sorted(p.name for p in Path(opt.ckpt_path).iterdir())
    if [r["mode"] for r in records] != ["train", "test"] or ckpts != ["checkpoint_00.pt"]:
        fail(f"phase 13a: records {records}, checkpoints {ckpts}")
    folded_ms = [s.elapsed_time(e) for s, e in spans[:steps]]
    wall = sorted(record["wall_s"])
    print(json.dumps({"multiview_trainer_smoke": {
        "config": "train_faceDP_dpnet + config_multi, use_multi, smoothL1 + folded", "batch": MULTIVIEW_BATCH,
        "crop": [H, W], "reference_views": views[1], "raw_hw": list(views[2:4]), "precision": "float32",
        "steps": steps, "fit_s": fit_s, "steps_per_s": steps / fit_s, "step_wall_s": record["wall_s"],
        "step_wall_median_s": wall[len(wall) // 2], "folded_forward_ms": folded_ms,
        "folded_share_of_step": statistics.median(folded_ms) / 1e3 / wall[len(wall) // 2],
        "dataloader_wait_s": pipes[0].wait, "peak_memory_gb": peak, "losses": losses, "params": len(after),
        "launches": launches, "card": card}}), flush=True)
    del trainer, record
    gc.collect()  # the trainer's DataLoader workers end with it
    torch.cuda.empty_cache()
    return launches


def multiview_state_dict(config) -> dict:
    """13a's CPU-comparable weights: `zoo_state_dict`'s, the PReLU slopes
    U(0.85, 0.95) from a seed, the first head's last BatchNorm bias raised
    by MULTIVIEW_HEAD_SHIFT."""
    import torch

    sd = zoo_state_dict(config)
    gen = torch.Generator().manual_seed(1)
    for name, t in sd.items():
        if name.endswith("prelu.weight"):
            sd[name] = 0.85 + 0.1 * torch.rand(t.shape, generator=gen)
    sd["conv_last_layer1.bn.bias"] = sd["conv_last_layer1.bn.bias"] + MULTIVIEW_HEAD_SHIFT
    return sd


def multiview_gradients(torch, config, sd, batch, device, dtype):
    """One train-mode forward, the losses and the backward of the
    multi-view run on `device` in `dtype` from `sd` on `batch`: the losses
    and each parameter's gradient (on the CPU, in f64)."""
    from dualpixelface_tpu_torch.losses import loss_selector
    from dualpixelface_tpu_torch.models import build_model
    from dualpixelface_tpu_torch.weights import load_state_dict

    model = load_state_dict(build_model(config, device="cpu"), sd).to(device=device, dtype=dtype).train()
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
    losses = loss_selector(config)(model(tb), tb)
    losses["final_loss"].backward()
    return ({k: float(v.detach()) for k, v in losses.items() if k.endswith("_loss")},
            {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()})


def multiview_against_cpu(torch, tmp: Path) -> dict:
    """Phase 13a': one train-mode step's losses and gradients of the
    multi-view run (the run config under `tmp`) at MULTIVIEW_CPU_HW,
    batch 2, from the same weights
    (`multiview_state_dict`) and batch (`profile_train.train_batch` with
    smooth views, `profile_train.multiview_keys`' geometry for depths about
    MULTIVIEW_HEAD_SHIFT), on the card and on the CPU:
      * in f64, where rounding cannot move a sample across a pixel
        boundary or a PReLU input across 0: the losses to 1e-10 relative
        and each parameter's gradient within MULTIVIEW_F64_TOL of the CPU's
        norm; a gradient the CPU gives as exactly 0 (the first head's PReLU
        slope: its inputs are all positive) exactly 0 on the card;
      * the card in f32 (exact: TF32 off): the losses to 1e-5 of the
        CPU's f64 ones; its gradients against the CPU's f64 ones,
        reported (the worst parameter): at these weights the deepest
        encoder stage's PReLU slope sums many cancelling terms, and the
        CPU's own f32 gradient of it lies 2.2e-2 from f64's, the card's
        1.0e-2, so an f32 comparison of the two devices holds rounding, not
        the port (held at 1e-3 it failed on that slope at three geometry
        seeds, 1.5e-2 the worst; NVIDIA H100 80GB HBM3, 700 W)."""
    import numpy as np

    from dualpixelface_tpu_torch.ops.precision import exact_f32
    from dualpixelface_tpu_torch.profile_train import multiview_keys, smooth_views, train_batch

    config = multiview_option(tmp, make_workspace=False)
    hw = MULTIVIEW_CPU_HW
    sd = multiview_state_dict(config)
    batch = {**train_batch(2, hw, hw, seed=5), **smooth_views(2, hw, hw, seed=5),
             **multiview_keys(np.random.default_rng(1), 2, hw, hw, depth=MULTIVIEW_HEAD_SHIFT)}
    exact_f32()  # built by hand: the f32 setting the Trainer applies
    runs, seconds = {}, {}
    for key in (("cuda", torch.float64), ("cpu", torch.float64), ("cuda", torch.float32)):
        t0 = time.perf_counter()
        runs[key] = multiview_gradients(torch, config, sd, batch, *key)
        seconds[f"{key[0]} {str(key[1])[6:]}"] = time.perf_counter() - t0

    def errs(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss = max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb)
        grads = {n: float((ga[n] - g).norm() / g.norm()) for n, g in gb.items() if g.norm() > 0}
        worst = max(grads, key=grads.get)
        return loss, grads, [worst, grads[worst]]

    loss64, _, worst64 = errs(("cuda", torch.float64), ("cpu", torch.float64))
    loss32, _, card32 = errs(("cuda", torch.float32), ("cpu", torch.float64))
    (lc, gc), (_, gg) = runs[("cpu", torch.float64)], runs[("cuda", torch.float64)]
    zero = sorted(n for n, g in gc.items() if not g.norm() > 0)
    summary = {"hw": hw, "losses_f64_cpu": lc, "losses_f32_cuda": runs[("cuda", torch.float32)][0],
               "f64_loss_rel_err": loss64, "f64_worst_grad": worst64, "f32_loss_rel_err_vs_f64": loss32,
               "f32_worst_grad_card_vs_f64": card32, "zero_grad_on_cpu": zero, "params": len(gc),
               "tolerances": [1e-10, MULTIVIEW_F64_TOL, 1e-5], "seconds": seconds,
               "cpu_threads": torch.get_num_threads()}
    print(json.dumps({"multiview_vs_cpu": summary}), flush=True)
    if set(lc) != {"smoothL1_loss", "folded_loss", "final_loss"} or lc["folded_loss"] <= 0 or loss64 > 1e-10 or \
            worst64[1] > MULTIVIEW_F64_TOL or any(bool(gg[n].any()) for n in zero) or loss32 > 1e-5:
        fail(f"phase 13a': the card's multi-view step disagrees with the CPU's: {summary}")
    return summary


def multiview_cli(card: str, tmp: Path) -> dict:
    """Phase 13b: the multi-view run through the CLI (`run_cli`), written
    under `tmp / "cli"` over a FaceDP multi-view fixture of MULTIVIEW_CLI_HW
    images (crops of 288x192, as phase 10b's), batch MULTIVIEW_CLI_BATCH:
    2 steps, a test pass, the checkpoint; the train record's folded loss
    finite and non-zero."""
    from dualpixelface_tpu_torch.data.SyntheticDP.fixture import write_fixture_tree, write_multiview_run

    h, w = MULTIVIEW_CLI_HW
    fixture = write_fixture_tree(tmp / "cli" / "rcv", **{**MULTIVIEW_FIXTURE, "height": h, "width": w})
    path = write_multiview_run(tmp / "cli", fixture, overrides={"epoch": 1, "batch_size": MULTIVIEW_CLI_BATCH})
    steps = 3 * MULTIVIEW_FIXTURE["n_train"] // MULTIVIEW_CLI_BATCH
    out = run_cli("13b", str(path), "dpnet", "chip_smoke_multiview", MULTIVIEW_CLI_BATCH, steps, card)
    folded = out["train_record"].get("folded_loss", math.nan)
    if not math.isfinite(folded) or folded == 0.0:
        fail(f"phase 13b: the train record's folded loss is {folded}")
    return out


def face_seg_state_dict(seed: int = 0) -> dict:
    """BiSeNet weights in the reference's names: `zoo_state_dict`'s recipe
    (convs N(0, 1) / sqrt(fan in), BatchNorm scales and running variances
    U(0.5, 1.5), biases and running means 0.1 N(0, 1))."""
    import torch

    from dualpixelface_tpu_torch.models.face_seg import BiSeNet

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in BiSeNet(19).state_dict().items():
        if not t.is_floating_point():
            out[name] = t
        elif t.ndim > 1:
            out[name] = torch.randn(t.shape, generator=gen) / math.sqrt(t[0].numel())
        elif name.endswith(("running_var", "weight")):
            out[name] = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            out[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return out


def face_mask_phase(torch, card: str, tmp: Path) -> dict:
    """Phase 13c: `FaceMaskEstimator(size=512)` on the card and on the CPU,
    weights from a reference-named state_dict file (`face_seg_state_dict`,
    loaded with strict=True), on one 768x576 uint8 image of smooth texture:
    the main head's logits within FACE_LOGIT_TOL of the largest, the masks
    alike on at least FACE_MASK_AGREEMENT of the pixels (the mask's share
    of the image reported); the launch counts set to 0 just before the card's calls and
    read just after (all 0); ms per image (host clock, synchronised: the
    host's normalisation, the resizes, the forward, the argmax) over 5 calls
    and the peak memory."""
    import numpy as np

    from dualpixelface_tpu_torch.models.face_seg import FaceMaskEstimator
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.profile_train import _blur

    path = tmp / "face_seg.pth"
    torch.save(face_seg_state_dict(), path)
    rng = np.random.default_rng(3)
    image = np.clip(128 + 400 * _blur(rng.standard_normal((H, W, 3)), 4.0), 0, 255).astype(np.uint8)
    gpu = FaceMaskEstimator(checkpoint=str(path), size=FACE_SIZE)
    cpu = FaceMaskEstimator(checkpoint=str(path), size=FACE_SIZE, device="cpu")
    gpu(image)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        mask = gpu(image)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    logits = gpu.logits(image).cpu()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ref_mask, ref_logits = cpu(image), cpu.logits(image)
    err = float((logits - ref_logits).abs().max() / ref_logits.abs().max())
    agree = float((mask == ref_mask).mean())
    print(json.dumps({"face_mask_smoke": {
        "size": FACE_SIZE, "image_hw": [H, W], "ms_per_image": sorted(lat)[len(lat) // 2], "ms_runs": lat,
        "peak_memory_gb": peak, "logit_rel_err": err, "mask_agreement": agree, "mask_share": float(mask.mean()),
        "tolerances": [FACE_LOGIT_TOL, FACE_MASK_AGREEMENT], "launches": launches, "card": card}}), flush=True)
    if any(launches.values()):
        fail(f"phase 13c: launch counts {launches}; the face parser runs no kernel of K1-K5")
    if mask.shape != (H, W) or err > FACE_LOGIT_TOL or agree < FACE_MASK_AGREEMENT:
        fail(f"phase 13c: the card's face mask disagrees with the CPU's (logits {err:.3e}, agreement {agree})")
    del gpu
    torch.cuda.empty_cache()
    return launches


def deform_conv2d_phase(torch, card: str) -> dict:
    """Phase 13d: `DeformConvPack2D(64, 64)`, plain and modulated, on
    [4, 192, 144, 64] (DCN_SHAPE) with its offset head seeded to offsets
    ~N(0, 1): the card's output, offsets and the gradients of x and of
    every parameter (a seeded cotangent) against the CPU's, at DCN_TOL and
    DCN_JUMP_TOL (why: beside them); the launch counts set to 0 just before
    the card's calls and read just after (all 0); the card's forward and
    forward + backward ms (CUDA events, 3 calls)."""
    from dualpixelface_tpu_torch.ops.deform_conv2d import DeformConvPack2D
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.tools import cuda_ms

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(DCN_SHAPE, generator=gen)
    c = DCN_SHAPE[-1]
    total = {}
    for modulated in (False, True):
        module = DeformConvPack2D(c, c, modulated=modulated, generator=gen)
        with torch.no_grad():
            w = module.conv_offset.weight
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()))
        out_shape = DCN_SHAPE[:3] + (c,)
        cot = torch.randn(out_shape, generator=gen)
        res = {}
        for device in ("cuda", "cpu"):
            m = DeformConvPack2D(c, c, modulated=modulated).to(device)
            m.load_state_dict(module.state_dict())
            xd = x.clone().to(device).requires_grad_(True)
            if device == "cuda":
                reset_launch_counts()
            out, offset = m(xd)
            out.backward(cot.to(device))
            res[device] = {k: v.detach().cpu().clone() for k, v in (
                ("out", out), ("offset", offset), ("x", xd.grad), *((n, p.grad) for n, p in m.named_parameters()))}
            if device == "cuda":
                torch.cuda.synchronize()
                launches = launch_counts()
                fwd_ms = cuda_ms(lambda: m(xd), 3)
                step_ms = cuda_ms(lambda: m(xd)[0].backward(cot.to(device)), 3)
        errs = {k: float((res["cuda"][k] - v).abs().max() / v.abs().max()) for k, v in res["cpu"].items()}
        norm_errs = {k: float((res["cuda"][k] - v).norm() / v.norm()) for k, v in res["cpu"].items()}
        offsets = float(res["cpu"]["offset"].abs().max())
        print(json.dumps({"deform_conv2d_smoke": {
            "modulated": modulated, "shape": list(DCN_SHAPE), "max_abs_offset": offsets, "rel_err": errs,
            "norm_rel_err": norm_errs, "tolerances": [DCN_TOL, DCN_JUMP_TOL], "fwd_ms": fwd_ms,
            "fwd_bwd_ms": step_ms, "launches": launches, "card": card}}), flush=True)
        if any(launches.values()):
            fail(f"phase 13d: launch counts {launches}; the 2-D deformable conv runs no kernel of K1-K5")
        if any(errs[k] > DCN_TOL for k in errs if k not in DCN_THROUGH_OFFSETS) or offsets < 1.0 or \
                any(norm_errs[k] > DCN_JUMP_TOL for k in DCN_THROUGH_OFFSETS):
            fail(f"phase 13d: the card's DeformConvPack2D (modulated={modulated}) disagrees with the CPU's: {errs}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    torch.cuda.empty_cache()
    return total


def last_modules_phase(torch, card: str, phase) -> dict:
    """Phase 13 (a, a', b, c, d). Returns K1-K5's launch counts in 13a, 13c
    and 13d, summed (all 0)."""
    import shutil
    import tempfile

    from dualpixelface_tpu_torch.data.SyntheticDP.fixture import write_fixture_tree, write_multiview_run

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase13_", dir=ROOT / "build"))
    try:
        fixture = write_fixture_tree(tmp / "rcv", **MULTIVIEW_FIXTURE)
        write_multiview_run(tmp, fixture, overrides={"epoch": 1})
        counts = [phase("13a", multiview_trainer, torch, card, tmp)]
        phase("13a'", multiview_against_cpu, torch, tmp)
        phase("13b", multiview_cli, card, tmp)
        counts.append(phase("13c", face_mask_phase, torch, card, tmp))
        counts.append(phase("13d", deform_conv2d_phase, torch, card))
        return {k: sum(c[k] for c in counts) for k in counts[0]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 14: `stereodpnet_plus` at widths past the committed ones, at the
# reference's 768x576: its ANM deform convs 51 -> 96 and 96 -> 96 (K1, K2
# and K5 at those Cin), its regression 96 bins (K3 and K4 at 24 planes)
WIDE_OVERRIDES = {"inplanes": 48, "level": 24}
# 14d: the general deform surface on [2, 8, 96, 72, 32] (B, D, H, W, C)
GENERAL_SHAPE = (2, 8, 96, 72, 32)


def general_modules_against_cpu(torch, card):
    """Phase 14d: the deform surface outside the ANM, the card against the
    CPU in f32, forward and every gradient (a seeded cotangent), on
    GENERAL_SHAPE: `deform_conv3d` at stride 2 with dilation 2 and at
    kernel (1, 3, 3) with padding (0, 1, 1) (the plain route: gather and
    matmul), `DeformConv3D(dimension="HW")` at 3x3x3 / s1 / p1 (K1 and K2,
    Co 32) and `DeformConvPack3D_d(dimension="T")` at stride 2 (its offset
    head cuDNN's conv3d, seeded non-zero). External offsets ~N(0, 1.5) sit
    at the same positions on both devices: every quantity within DCN_TOL
    of its largest entry. Pack_d's offsets come from each device's conv,
    ~1e-6 apart, so a few samples lie across a voxel boundary from each
    other: the gradients that pass through the offsets (x's and the head's)
    are held in norm, within DCN_JUMP_TOL, as phase 13d holds them."""
    from dualpixelface_tpu_torch.ops import deform_conv3d as dc

    gen = torch.Generator().manual_seed(14)
    b, d, h, w, c = GENERAL_SHAPE
    x = torch.randn(GENERAL_SHAPE, generator=gen)

    def fn_case(ks, stride, padding, dilation):
        weight = torch.randn(ks + (c, c), generator=gen) / math.sqrt(math.prod(ks) * c)
        bias = torch.randn(c, generator=gen)
        out = tuple((n + 2 * p - q * (k - 1) - 1) // s + 1
                    for n, p, q, k, s in zip((d, h, w), padding, dilation, ks, stride))
        off = torch.randn((b,) + out + (3 * math.prod(ks),), generator=gen) * 1.5
        call = lambda xx, oo, ww, bb: dc.deform_conv3d(xx, oo, ww, bb, stride, padding, dilation)  # noqa: E731
        return call, [x, off, weight, bias]

    cases = {"deform_conv3d s2 d2": fn_case((3, 3, 3), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
             "deform_conv3d k133 p011": fn_case((1, 3, 3), (1, 1, 1), (0, 1, 1), (1, 1, 1))}
    hw_mod = dc.DeformConv3D(c, c, dimension="HW")
    cases["DeformConv3D HW"] = (hw_mod, [x, torch.randn((b, d, h, w, 2 * 27), generator=gen) * 1.5])
    pack_d = dc.DeformConvPack3D_d(c, c, stride=2, dimension="T")
    with torch.no_grad():
        wo = pack_d.conv_offset.weight
        wo.copy_(torch.randn(wo.shape, generator=gen) * 3.0 / math.sqrt(wo[0].numel()))
    cases["DeformConvPack3D_d T"] = (pack_d, [x])
    for name, (call, args) in cases.items():
        res = {}
        for device in ("cuda", "cpu"):
            leaves = [a.clone().to(device).requires_grad_(True) for a in args]
            fn = copy.deepcopy(call).to(device) if isinstance(call, torch.nn.Module) else call
            out = fn(*leaves)
            params = list(fn.named_parameters()) if isinstance(fn, torch.nn.Module) else []
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(device)
            out.backward(cot)
            res[device] = {"out": out.detach().cpu(), **{f"arg{i}": t.grad.cpu() for i, t in enumerate(leaves)},
                           **{n: p.grad.cpu() for n, p in params}}
        torch.cuda.synchronize()
        errs = {k: float((res["cuda"][k] - v).abs().max() / v.abs().max()) for k, v in res["cpu"].items()}
        norm_errs = {k: float((res["cuda"][k] - v).norm() / v.norm()) for k, v in res["cpu"].items()}
        jumps = ("arg0", "conv_offset.weight", "conv_offset.bias") if name.startswith("DeformConvPack3D_d") else ()
        print(json.dumps({"general_deform_smoke": {"case": name, "shape": list(GENERAL_SHAPE),
                                                   "out_shape": list(res["cpu"]["out"].shape), "rel_err": errs,
                                                   "norm_rel_err": norm_errs, "held_in_norm": list(jumps),
                                                   "tolerances": [DCN_TOL, DCN_JUMP_TOL], "card": card}}), flush=True)
        if any(errs[k] > DCN_TOL for k in errs if k not in jumps) or any(norm_errs[k] > DCN_JUMP_TOL for k in jumps):
            fail(f"phase 14d: the card's {name} disagrees with the CPU's: {errs} {norm_errs}")


def time_wide_routes(torch, card):
    """Phase 4d: each widened route at phase 14's shapes, both dtypes: K1 at
    the serving batch 4 (Cin 51 and 96, Co 96, windowed; a row sums both)
    and K2 at the train batch 2 (the same), each first held against its
    plain version on the same inputs (`REL_TOL`; K2's four gradients at
    `BWD_TOL`, its f32 plain version on the two halves of the batch,
    `bwd_plain_in_halves`), K3 at [4, 24, 192, 144] and K4 at [2, 24, 192,
    144] (phase 3d checks both at these shapes); then ms (CUDA events),
    device ms (`tools.device_ms`), plain ms and the work the bounds price
    (`K1_F32_OPS`, `K2_F32_OPS`, `tools.bench_softargmin.work`). A K1/K2
    row's `max_abs_err` is the largest of its checks'."""
    from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
    from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
        bwd_route, deform_conv3d_bwd, deform_conv3d_bwd_plain, deform_conv3d_fused, deform_conv3d_plain, fwd_route)
    from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import (
        fused_softargmin, fused_softargmin_bwd, fused_softargmin_bwd_plain, fused_softargmin_plain)
    from dualpixelface_tpu_torch.tools import bench_softargmin, cuda_ms, device_ms

    c = WIDE_OVERRIDES["inplanes"]
    cins, co, planes = (c + 3, 2 * c), 2 * c, WIDE_OVERRIDES["level"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    for dtype, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        item = torch.finfo(dtype).bits // 8
        for k, batch in (("K1", B), ("K2", TB)):
            row = rows.setdefault(f"{k} {dname}", {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
                                                   "flops_mma": 0.0, "ops_f32": 0.0, "bytes": 0.0, "batch": batch,
                                                   "cins": cins, "co": co})
            shape = (batch, 4, H // 4, W // 4)
            m = math.prod(shape)
            for cin in cins:
                x, off, w, bias, g = width_inputs(torch, gen, cin, co, dtype, shape)
                label = f"{shape} Cin={cin} Co={co} aperture=True (phase 14's)"
                if k == "K1":
                    fn = lambda: deform_conv3d_fused(x, off, w, bias, aperture=True)  # noqa: E731
                    plain = lambda: deform_conv3d_plain(x, off, w, bias, aperture=True)  # noqa: E731
                    errs = [compare(f"K1 deform_conv3d_fused [{fwd_route(dtype)}] {label}", fn(), plain(), dname)]
                    row["flops_mma"] += 2.0 * m * 27 * cin * co
                    row["ops_f32"] += K1_F32_OPS * m * 27 * cin
                    row["bytes"] += sum(t.numel() for t in (x, off, w, bias)) * item + m * co * item
                else:
                    fn = lambda: deform_conv3d_bwd(x, off, w, bias, g, aperture=True)  # noqa: E731
                    if dtype == torch.float32:
                        plain = lambda: bwd_plain_in_halves(torch, x, off, w, bias, g, True)  # noqa: E731
                    else:
                        plain = lambda: deform_conv3d_bwd_plain(x, off, w, bias, g, aperture=True)  # noqa: E731
                    errs = [compare(f"K2 deform_conv3d_bwd [{bwd_route(dtype)}] {gname} {label}", a, r, dname,
                                    BWD_TOL[dname][gname])
                            for gname, a, r in zip(("gx", "goff", "gw", "gb"), fn(), plain())]
                    row["flops_mma"] += 2 * 2.0 * m * 27 * cin * co
                    row["ops_f32"] += K2_F32_OPS * m * 27 * cin
                    row["bytes"] += (sum(t.numel() for t in (x, off, w)) * 2 + g.numel()) * item
                row["max_abs_err"] = max(row["max_abs_err"], *errs)
                torch.cuda.empty_cache()
                row["ms"] += cuda_ms(fn, 3)
                row["device_ms"] += device_ms(fn, 3)
                row["plain_ms"] += cuda_ms(plain, 1)
                del x, off, w, bias, g
                torch.cuda.empty_cache()
        disp = regression_disparities(-4, 12, planes, 4)
        for k, batch in (("K3", B), ("K4", TB)):
            cost = softargmin_cost(torch, gen, batch, planes, (H // 4, W // 4), dtype)
            if k == "K3":
                fn = lambda: fused_softargmin(cost, disp, 4)  # noqa: E731
                plain = lambda: fused_softargmin_plain(cost, disp, 4)  # noqa: E731
            else:
                g = torch.randn((batch, H, W), generator=gen, device="cuda").to(dtype)
                fn = lambda: fused_softargmin_bwd(cost, g, disp, 4)  # noqa: E731
                plain = lambda: fused_softargmin_bwd_plain(cost, g, disp, 4)  # noqa: E731
            rows[f"{k} {dname}"] = {"ms": cuda_ms(fn, 20), "device_ms": device_ms(fn, 20), "plain_ms": cuda_ms(plain, 2),
                                    "batch": batch, "planes": planes,
                                    **bench_softargmin.work(k, tuple(cost.shape), item)}
            torch.cuda.empty_cache()
    for key, row in rows.items():
        print(json.dumps({"wide_run": {"route": key, **row, "card": card}}), flush=True)
    return rows


def wide_phase(torch, card, phase) -> dict:
    """Phase 14: `stereodpnet_plus` at WIDE_OVERRIDES (seeded weights with
    non-zero offset heads): 14a serving (3 batches of 4 at 768x576, bf16;
    launches per forward K1 2, K3 1, K5 2), 14b 3 bf16 train steps (batch 2,
    Adam; per step K1 2, K2 2, K3 3, K4 3, K5 2), 14c the card's f32
    forward against the CPU's at 192x192 (phase 6's tolerances), each with
    the launch counts set to 0 just before and read just after; 14d the
    general deform modules (`general_modules_against_cpu`). Returns 14a's
    and 14b's launch counts."""
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.serve import seeded_state_dict

    config = load_config("stereodpnet_plus", model_overrides=WIDE_OVERRIDES)
    sd = seeded_state_dict(config)
    serving = phase("14a", serve_full_width, torch, config, sd, card, {"K1": 2, "K3": 1, "K5": 2}, "serving_wide")
    train = phase("14b", train_full_width, torch, sd, card, "stereodpnet_plus", WIDE_OVERRIDES)
    phase("14c", check_against_cpu, torch, config, sd)
    with kernel_checks_in_f32(torch):
        phase("14d", general_modules_against_cpu, torch, card)
    return {"serving": serving, "train": train}


# phase 15: a reference-format checkpoint evaluated through the CLI. The
# committed f32 eval config (`stereodpnet`: exact attention, unbounded
# deform, unfused regression; test mode, batch 4) on SyntheticDP at the
# reference's 768x576, which config_test's centre crop (ratio 1, factor 96)
# keeps whole; 8 test samples, 2 eval batches. Nothing else is cut.
REFERENCE_EVAL_CONFIG = "eval_synthetic_stereodpnet"
REFERENCE_EVAL_DATA = {"height": H, "width": W, "test_samples": 8}
REFERENCE_EVAL_LAUNCHES = {"K1": 2, "K5": 2}  # per eval forward; K2-K4 none
# the reference's buffers the port has no place for, written into the
# reference-format checkpoint so the converter has to leave them out
REFERENCE_ONLY = ("cost_volume.costrange", "normal_estimator.grid", "regression_layer.disp_values")
# the CLI's test record against the in-process `Trainer.test`'s: another
# process may take other cuDNN algorithms (sums in another order). The
# continuous entries within REFERENCE_RECORD_RTOL (they differed by 4e-8 at
# most on an H100 80GB HBM3 at 700 W); absolute_dp's a1-a3 are shares of
# masked pixels under a threshold, where one pixel that rounds across it
# moves the share by 1 / (batches x its batch's masked pixels), 7.4e-7 or
# 6.3e-6 of a1 there (one pixel flipped in a run of phase 15 alone). A
# relative depth noise d flips the pixels whose ratio lies within d of a
# threshold: with 0.12 of the ratios in [1, 1.01), about 24 d of the
# 1.35 M masked pixels, ~30 for d = 1e-6. Held to RECORD_PIXEL_FLIPS such
# pixels, 4.7e-5 of a share; a fault moves a share by 1e-3 and more.
REFERENCE_RECORD_RTOL = 1e-5
RECORD_SHARES = ("absolute_dp/a1", "absolute_dp/a2", "absolute_dp/a3")
RECORD_PIXEL_FLIPS = 64
# 15b: `metrics_torch` on the card against the same function on CPU copies
# (float32 sums of 442,368 pixels a sample in another order: the largest
# difference, WMAE's after 5 IRLS steps, was 2.3e-5 of its value, the
# others below 2e-7 (H100 80GB HBM3, 700 W), so 1e-4 of each value and 1e-6
# absolute), and the f32 case against the numpy pack at
# tests/test_affine_dp_jax.py's tolerance
METRICS_TOL = {"rtol": 1e-4, "atol": 1e-6}
NUMPY_METRICS_TOL = {"rtol": 2e-3, "atol": 2e-4}


def reference_checkpoint(torch, path: Path) -> dict:
    """Write the committed plateau checkpoint in the reference's format
    (`weights.state_dict_from_jax`, then the port's exporter), with the
    reference-only buffers and seeded BatchNorm counts added, as
    {"state_dict": ...} to `path`; returns that state_dict."""
    import numpy as np

    from dualpixelface_tpu_torch.tools.export_stereodpnet_checkpoint import export_stereodpnet_state_dict
    from dualpixelface_tpu_torch.weights import read_flax_msgpack, state_dict_from_jax

    tree = read_flax_msgpack(ROOT / "tests" / "data" / "serving_plateau_192.msgpack")
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_stereodpnet_state_dict(state_dict_from_jax(tree["params"], tree["batch_stats"])).items()}
    gen = torch.Generator().manual_seed(15)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.randint(1, 10**6, (), generator=gen)
    sd.update({k: torch.randn(8, generator=gen) for k in REFERENCE_ONLY})
    torch.save({"state_dict": sd}, path)
    return sd


def capture_first_eval(trainer, box: dict) -> None:
    """Wrap the eval step `trainer.init_state` makes so that its first
    call's device batch and results land in `box`, and each call's count
    of masked pixels in `box["masked"]`."""
    init_state = trainer.init_state

    def init_and_wrap(steps_per_epoch):
        state = init_state(steps_per_epoch)
        step = trainer.eval_step

        def recorded(state, batch):
            results = step(state, batch)
            if "batch" not in box:
                box.update(batch=batch, results=results)
            box.setdefault("masked", []).append((batch["mask"] > 0).sum())
            return results

        trainer.eval_step = recorded
        return state

    trainer.init_state = init_and_wrap


def reference_eval(torch, card: str, tmp: Path) -> dict:
    """Phase 15a: a reference-format checkpoint (`reference_checkpoint`)
    converted by the converter's CLI entry
    (`tools.convert_stereodpnet_checkpoint.main` with the arguments of
    `python -m ... <ckpt> <out.pt> --config <config>`, on the card, its
    default), then
    evaluated through the CLI (`run_cli`, test mode, `--load_model`, the
    config's `load_strict: true`) on a copy of the config whose dataset is
    REFERENCE_EVAL_DATA; the same checkpoint in this process through
    `Trainer.test` with the launch counts set to 0 just before and read
    just after (per forward K1 2, K5 2, the rest 0), its test record
    equal to the CLI's within REFERENCE_RECORD_RTOL (a1-a3 within
    RECORD_PIXEL_FLIPS pixels); then the checkpoint
    exported back (`export_stereodpnet_checkpoint`) must equal the `.pt`
    and the reference payload, tensor for tensor, but for the
    reference-only buffers. Returns the launch counts, the first eval
    batch and its results (on the card) for 15b."""
    from dualpixelface_tpu_torch.config import Configuration
    from dualpixelface_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dualpixelface_tpu_torch.tools import convert_stereodpnet_checkpoint, export_stereodpnet_checkpoint
    from dualpixelface_tpu_torch.train.checkpoint import load_checkpoint
    from dualpixelface_tpu_torch.train.trainer import Trainer

    reference = reference_checkpoint(torch, tmp / "reference.ckpt")
    data = json.loads((ROOT / "dualpixelface_tpu_torch" / "data" / "SyntheticDP" / "config.json").read_text())
    (tmp / "synthetic.json").write_text(json.dumps({**data, **REFERENCE_EVAL_DATA}))
    run = json.loads((ROOT / "configs" / f"{REFERENCE_EVAL_CONFIG}.json").read_text())
    if run["mode"] != "test" or run["load_strict"] is not True or run["precision"] != 32:
        fail(f"phase 15a: {REFERENCE_EVAL_CONFIG} is committed as test mode, load_strict, f32; it reads {run}")
    (tmp / "configs").mkdir()
    config = tmp / "configs" / f"{REFERENCE_EVAL_CONFIG}.json"
    config.write_text(json.dumps({**run, "dataset_config": str(tmp / "synthetic")}))

    converted = tmp / "converted.pt"
    t0 = time.perf_counter()
    # the CLI's own entry in this process (a subprocess would add ~10 s of
    # start-up; tests/test_torch_reference_checkpoint.py runs `python -m`)
    convert_stereodpnet_checkpoint.main([str(tmp / "reference.ckpt"), str(converted), "--config", str(config)])
    convert_s = time.perf_counter() - t0
    if not converted.is_file():
        fail(f"phase 15a: the converter wrote no {converted}")
    cli = run_cli("15a", str(config), run["model_name"], "chip_smoke_reference", run["batch_size"], None, card,
                  load_model=str(converted))

    trainer = Trainer(Configuration(str(config), "phase15", load_model=str(converted), root=tmp).get_config())
    box: dict = {}
    capture_first_eval(trainer, box)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    agg = trainer.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = -(-REFERENCE_EVAL_DATA["test_samples"] // run["batch_size"])
    want = {**dict.fromkeys(launches, 0), **{k: n * batches for k, n in REFERENCE_EVAL_LAUNCHES.items()}}
    print(f"reference eval launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"phase 15a: launch counts {launches} != {want}: the eval did not run through every kernel")
    res = box["results"]
    check_results(torch, res, run["batch_size"], H, W, bins=4 * trainer.opt.model.level)
    if res["pred_depth"].dtype != torch.float32:
        fail(f"phase 15a: the f32 eval returned {res['pred_depth'].dtype}")

    record = {f"{m}/{k}": v for m, d in agg.items() for k, v in d.items()}
    cli_record = {k: v for k, v in cli["test_record"].items() if k != "mode"}
    share_tol = RECORD_PIXEL_FLIPS / (batches * min(int(m) for m in box["masked"]))
    if set(record) != set(cli_record):
        fail(f"phase 15a: the in-process record's keys {sorted(record)} are not the CLI's {sorted(cli_record)}")

    def over_tol(k, a, b):
        """|a - b| over its tolerance (both NaN: 0; one NaN: inf)."""
        if math.isnan(a) or math.isnan(b):
            return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
        tol = share_tol if k in RECORD_SHARES else REFERENCE_RECORD_RTOL * max(abs(a), abs(b), 1e-12)
        return abs(a - b) / tol

    diffs = {k: over_tol(k, v, cli_record[k]) for k, v in record.items()}
    worst = max(diffs, key=diffs.get)
    print(f"in-process Trainer.test vs the CLI's test record: largest diff over its tolerance {diffs[worst]:.3f} "
          f"({worst}; rel {REFERENCE_RECORD_RTOL:g}, shares {share_tol:.3e}) over {len(diffs)} entries", flush=True)
    if not diffs[worst] <= 1.0:
        fail(f"phase 15a: the in-process record {record} differs from the CLI's {cli_record}")

    back = tmp / "back.ckpt"
    export_stereodpnet_checkpoint.main([str(converted), str(back)])
    exported = torch.load(back, map_location="cpu")["state_dict"]
    model_sd = load_checkpoint(converted)["model"]
    if set(exported) != set(model_sd) or set(exported) != set(reference) - set(REFERENCE_ONLY):
        fail("phase 15a: the export's keys differ from the .pt's or from the reference payload's")
    unequal = [k for k, v in exported.items()
               if not (torch.equal(v, model_sd[k].cpu()) and torch.equal(v, reference[k]))]
    if unequal:
        fail(f"phase 15a: the export differs from the .pt or the reference payload at {unequal[:10]}")
    summary = {"config": REFERENCE_EVAL_CONFIG, "hw": [H, W], "batch": run["batch_size"], "batches": batches,
               "convert_s": convert_s, "cli_s": cli["cli_s"], "test_s": test_s, "launches": launches,
               "record_diff_over_tol": diffs, "exported_tensors": len(exported), "card": card}
    print(json.dumps({"reference_eval": summary}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "batch": box["batch"], "results": res, "state_dict": reference}


def tie_share(torch, x) -> float:
    """The share of the entries of each row of x [B, ...] whose value
    another entry of the row shares, averaged over the rows."""
    rows = x.reshape(x.shape[0], -1)
    return sum(1.0 - torch.unique(r).numel() / r.numel() for r in rows) / rows.shape[0]


def metrics_on_card(torch, card: str, ref: dict) -> dict:
    """Phase 15b: `metrics.affine_dp.metrics_torch` on the card on 15a's
    f32 eval outputs (pred_depth against the batch's disparity and mask, as
    the benchmark measures), and on the bf16 `stereodpnet_plus` serving
    forward (phase 5's path: K1, K3, K5) of the same batch with the same
    weights: each against the same function on CPU copies within
    METRICS_TOL; the f32 case also against the numpy pack within
    NUMPY_METRICS_TOL (the bf16 case, full of ties that the numpy pack's
    unstable sort breaks in its own order, prints its tie share and its
    difference instead). Then ms per batch of the card's twin (CUDA
    events) and of the host's numpy pack on host arrays."""
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.metrics.affine_dp import metrics, metrics_torch
    from dualpixelface_tpu_torch.serve import Predictor
    from dualpixelface_tpu_torch.tools import cuda_ms

    batch = ref["batch"]
    disp, mask = batch["disp"], batch["mask"]
    cases = {"float32": ref["results"]["pred_depth"][:, 0]}
    # the reference payload's weights, without the buffers the port has no place for
    sd = {k: v for k, v in ref["state_dict"].items() if k not in REFERENCE_ONLY}
    serving = Predictor(load_config("stereodpnet_plus"), state_dict=sd, device="cuda", dtype=torch.bfloat16)
    out = serving({k: batch[k] for k in ("left", "right", "K", "abvalue")})
    cases["bfloat16"] = out["pred_depth"][:, 0]
    del serving, out
    rows = {}
    for dname, pred in cases.items():
        if pred.device.type != "cuda" or str(pred.dtype) != f"torch.{dname}" or tuple(pred.shape) != tuple(disp.shape):
            fail(f"phase 15b: the {dname} prediction is {pred.dtype} {tuple(pred.shape)} on {pred.device}")
        got = metrics_torch(pred, disp, mask)
        if got.device.type != "cuda":
            fail("phase 15b: metrics_torch left the card")
        host = metrics_torch(pred.cpu(), disp.cpu(), mask.cpu())
        got_h = got.cpu()
        diff = (got_h - host).abs()
        ok = bool(torch.isfinite(got_h).all()) and bool((diff <= METRICS_TOL["atol"] + METRICS_TOL["rtol"] * host.abs()).all())
        pred_np, disp_np, mask_np = pred.float().cpu().numpy(), disp.cpu().numpy(), mask.cpu().numpy()
        numpy_vals = metrics(pred_np, disp_np, mask_np)
        numpy_diff = [abs(a - b) for a, b in zip(got_h.tolist(), numpy_vals)]
        card_ms = cuda_ms(lambda: metrics_torch(pred, disp, mask), iters=5)
        t0 = time.perf_counter()
        for _ in range(2):
            metrics(pred_np, disp_np, mask_np)
        numpy_ms = (time.perf_counter() - t0) / 2 * 1e3
        rows[dname] = {"card": got_h.tolist(), "cpu": host.tolist(), "card_vs_cpu_abs": diff.tolist(),
                       "numpy": numpy_vals, "card_vs_numpy_abs": numpy_diff,
                       "pred_tie_share": tie_share(torch, pred), "disp_tie_share": tie_share(torch, disp),
                       "card_ms": card_ms, "numpy_ms": numpy_ms}
        print(f"metrics_torch {dname}: card {got_h.tolist()} vs CPU {host.tolist()}: abs diff {diff.tolist()} "
              f"(tol {METRICS_TOL}); numpy pack {numpy_vals}, abs diff {numpy_diff}; ties: pred "
              f"{rows[dname]['pred_tie_share']:.4f}, disp {rows[dname]['disp_tie_share']:.4f}; "
              f"card {card_ms:.3f} ms, numpy {numpy_ms:.1f} ms a batch of {pred.shape[0]}", flush=True)
        if not ok:
            fail(f"phase 15b: metrics_torch on the card differs from the CPU on the {dname} outputs")
        if dname == "float32" and not all(
                d <= NUMPY_METRICS_TOL["atol"] + NUMPY_METRICS_TOL["rtol"] * abs(v) for d, v in zip(numpy_diff, numpy_vals)):
            fail("phase 15b: metrics_torch on the card differs from the numpy pack on the f32 outputs")
    print(json.dumps({"metrics_on_card": {**rows, "shape": list(disp.shape), "card": card}}), flush=True)
    return rows


def reference_eval_phase(torch, card: str, phase) -> dict:
    """Phase 15 (a, b) in a directory of its own under build/, removed
    after. Returns 15a's launch counts."""
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase15_", dir=ROOT / "build"))
    try:
        ref = phase("15a", reference_eval, torch, card, tmp)
        phase("15b", metrics_on_card, torch, card, ref)
        return ref["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "dualpixelface_tpu_torch" / "csrc").is_dir():
        print(f"FAIL: the port's package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dualpixelface_tpu_torch.config import load_config
    from dualpixelface_tpu_torch.ops.kernels import _build
    from dualpixelface_tpu_torch.serve import seeded_state_dict
    from dualpixelface_tpu_torch.tools import PEAK_BF16, PEAK_F32, PEAK_SFU, PEAK_TF32, bench_softargmin, bound_ms

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + json.dumps({k: round(v["seconds"], 1) for k, v in report.items()}), flush=True)
    print_build_report(report)

    seconds = {"2": time.perf_counter() - t0}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s wall", flush=True)
        return out

    print(f"TF32 flags (cudnn, matmul) at the start: {tf32_flags(torch)}", flush=True)
    with kernel_checks_in_f32(torch):
        err, timing = phase("3, 4", check_and_time_kernels, torch)
        phase("3b, 4b", check_and_time_backward_kernels, torch, err, timing)
        phase("3d, 4c", check_and_time_softargmin, torch, err, timing)
        phase("3c", check_edge_shapes, torch)
        wide_rows = phase("4d", time_wide_routes, torch, card)
    print(f"TF32 flags (cudnn, matmul) after the kernel checks: {tf32_flags(torch)}", flush=True)
    config = load_config("stereodpnet_plus")
    exact = load_config("stereodpnet")
    sd = seeded_state_dict(config)  # one tree: stereodpnet's seeded weights are the same
    serving = phase("5", serve_full_width, torch, config, sd, card, {"K1": 2, "K3": 1, "K5": 2})
    serving_exact = phase("5b", serve_full_width, torch, exact, sd, card, {"K1": 2, "K3": 0, "K5": 2},
                          "serving_exact")
    phase("5c", serve_graphs_check, torch, config, sd, card, {"K1": 2, "K3": 1, "K5": 2})
    phase("5c exact", serve_graphs_check, torch, exact, sd, card, {"K1": 2, "K3": 0, "K5": 2})
    phase("6", check_against_cpu, torch, config, sd)
    phase("6b", check_against_cpu, torch, exact, sd)
    launches = phase("7", train_full_width, torch, sd, card)
    launches_bench = phase("7b", train_full_width, torch, sd, card, "bench")
    phase("8", train_against_cpu, torch)
    with kernel_checks_in_f32(torch):
        tools = phase("9", tools_phase, torch)
    launches_trainer, reference = phase("10", trainer_full_width, torch, card)
    phase("10b", cli_subprocess, card)
    ddp = phase("11", ddp_phase, torch, card, reference)
    launches_ddp = next(iter(ddp.values()))
    launches_zoo = zoo_phase(torch, card, phase)
    launches_last = last_modules_phase(torch, card, phase)
    launches_wide = wide_phase(torch, card, phase)
    launches_reference = reference_eval_phase(torch, card, phase)
    print(json.dumps({"phase_seconds": seconds, "total_seconds": time.perf_counter() - t0}), flush=True)
    k5, t1 = timing["K5"], tools["T1"]
    chain_ms = sum(r["chain_ms"] for r in t1["runs"])
    t1f, t4f = t1["f32_route"], tools["T4"]["f32_route"]
    print(json.dumps({"yardsticks": {
        "K5_bf16_ms": k5["ms"], "K5_cudnn_best_ms": k5["library_ms"],
        "K5_cudnn_layouts": [r["cudnn_layout"] for r in k5["runs"]], "K5_no_slower": k5["ms"] <= k5["library_ms"],
        "T1_bf16_ms": t1["ms"], "T1_chain_ms": chain_ms, "T1_no_slower": t1["ms"] <= chain_ms,
        "T1_f32_ms": t1f["ms"], "T1_f32_cudnn_ms": t1f["library_ms"], "T1_f32_chain_ms": t1f["chain_ms"],
        "T4_f32_ms": t4f["ms"], "T4_f32_bmm_ms": t4f["library_ms"], "card": card}}), flush=True)

    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5"):
        t = timing[k]
        # contractions at their type's peak, other f32 work on the CUDA
        # cores, exps on the special-function units
        b_ms, b_by = bound_ms(t["bytes"], (t["flops"], PEAK_BF16), (t.get("flops_f32", 0.0), PEAK_F32),
                              (t.get("exps", 0.0), PEAK_SFU))
        kernels.append({
            "name": f"{k} {NAMES[k]}", "route": "cuda",
            "source": f"dualpixelface_tpu_torch/csrc/{SOURCES[k]}", "replaces": TPU_SITES[k],
            "launches": launches[k], "launches_serving": serving[k], "launches_serving_exact": serving_exact[k],
            "launches_train_bench": launches_bench[k], "launches_trainer": launches_trainer[k],
            "launches_ddp": [r["launches"][k] for r in launches_ddp],
            "launches_zoo": {m: c[k] for m, c in launches_zoo.items()}, "launches_last_modules": launches_last[k],
            "max_abs_err": err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "launches_wide": {p: c[k] for p, c in launches_wide.items()},
            "launches_reference_eval": launches_reference[k],
        })
        if k != "K5":
            # phase 4d's widened routes: bf16 priced as above, f32 with the
            # contractions three times over as TF32 (`split_bound_ms`)
            kernels[-1]["wide_route"] = wide = {"overrides": WIDE_OVERRIDES}
            for dname in ("bfloat16", "float32"):
                r = wide_rows[f"{k} {dname}"]
                if k in ("K1", "K2"):
                    peak = (PEAK_BF16, 1) if dname == "bfloat16" else (PEAK_TF32, 3)
                    w_ms, w_by = bound_ms(r["bytes"], (peak[1] * r["flops_mma"], peak[0]), (r["ops_f32"], PEAK_F32))
                else:
                    w_ms, w_by = bench_softargmin.bound(r)
                wide[dname] = {**r, "bound_ms": w_ms, "bound_by": w_by,
                               "launches": {p: c[k] for p, c in launches_wide.items()}}
        if "f32_route" in t:
            # the f32 route at the trainer path's batch 4: bound_ms with
            # every operation on the CUDA cores, split_bound_ms with the
            # contractions three times over as TF32 on the tensor cores
            f = t["f32_route"]
            ops = f["flops_mma"] + f["ops_f32"]
            f_ms, f_by = bound_ms(f["bytes"], (ops, PEAK_F32))
            s_ms, s_by = bound_ms(f["bytes"], (3 * f["flops_mma"], PEAK_TF32), (f["ops_f32"], PEAK_F32))
            kernels[-1]["f32_route"] = {
                "batch": TRAINER_BATCH, "ms": f["ms"], "device_ms": f["device_ms"], "plain_ms": f["plain_ms"],
                "library_ms": f["library_ms"], "bound_ms": f_ms, "bound_by": f_by, "split_bound_ms": s_ms,
                "split_bound_by": s_by, "ops": ops, "flops_mma": f["flops_mma"], "bytes": f["bytes"],
                "launches_per_trainer_step": TRAIN_STEP_LAUNCHES[k]}
    for k, row in tools.items():
        kernels.append({
            "name": f"{k} {NAMES[k]}", "route": "cuda",
            "source": f"dualpixelface_tpu_torch/csrc/{SOURCES[k]}", "replaces": TPU_SITES[k],
            "launches": row["launches"], "launches_trainer": launches_trainer[k],
            "launches_ddp": [r["launches"][k] for r in launches_ddp], "launches_last_modules": launches_last[k],
            "launches_reference_eval": launches_reference[k], "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": "operations" if 2 * row["bound_ops_ms"] >= row["bound_ms"] else "bytes",
            "library_ms": row["library_ms"], "runs": len(row["runs"]),
        })
        if "f32_route" in row:
            # the tool's f32 runs: bound_ms with every operation on the
            # CUDA cores, split_bound_ms with the products three times over
            # as TF32 on the tensor cores
            f = row["f32_route"]
            f_ms, f_by = bound_ms(f["bytes"], (f["flops_mma"], PEAK_F32))
            s_ms, s_by = bound_ms(f["bytes"], (3 * f["flops_mma"], PEAK_TF32))
            kernels[-1]["f32_route"] = {**f, "bound_ms": f_ms, "bound_by": f_by, "split_bound_ms": s_ms,
                                        "split_bound_by": s_by}
    print(json.dumps({"work": {k: {key: v for key, v in timing[k].items() if key.startswith(("flops", "bytes", "exps"))}
                               for k in timing}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
