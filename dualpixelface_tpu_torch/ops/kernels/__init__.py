"""Hand-written CUDA kernels for Hopper, one per TPU Pallas kernel of the
JAX package: K1-K5 on the serving and train paths, T1-T4 behind the tools
(`dualpixelface_tpu_torch/tools/`). Each module holds the wrappers (kernel
for CUDA tensors, plain PyTorch version for CPU tensors) and the plain
versions; the CUDA sources are in `dualpixelface_tpu_torch/csrc/`. Each
launch counts on the tracer's `launch.<id>` counter (`utils/profiling`),
which `launch_counts` reads."""
from dualpixelface_tpu_torch.ops.kernels import conv3d_dslice, conv3d_dslice_v2, deform_fused, fused_softargmin, prims
from dualpixelface_tpu_torch.utils import profiling


def kernel_wrappers() -> dict:
    """The wrapper of each kernel by its id (K1-K5, T1-T4)."""
    return {
        "K1": deform_fused.deform_conv3d_fused,
        "K2": deform_fused.deform_conv3d_bwd,
        "K3": fused_softargmin.fused_softargmin,
        "K4": fused_softargmin.fused_softargmin_bwd,
        "K5": conv3d_dslice.conv3d_dslice,
        "T1": conv3d_dslice_v2.conv3d_dslice_v2,
        "T2": prims.lane_gather_sum,
        "T3": prims.transpose_sum,
        "T4": prims.batched_dot,
    }


def launch_counts() -> dict:
    """Launches of each kernel by its id since the last reset."""
    counts = profiling.counters()
    return {k: counts.get(f"launch.{k}", 0) for k in kernel_wrappers()}


def reset_launch_counts() -> None:
    profiling.reset_counters("launch.")
