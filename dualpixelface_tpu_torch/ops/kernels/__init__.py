"""Hand-written CUDA kernels for Hopper, one per TPU Pallas kernel of the
JAX package: K1-K5 on the serving and train paths, T1-T4 behind the tools
(`dualpixelface_tpu_torch/tools/`). Each module holds the wrappers (kernel
for CUDA tensors, plain PyTorch version for CPU tensors), the plain
versions and the launch counters; the CUDA sources are in
`dualpixelface_tpu_torch/csrc/`."""
from dualpixelface_tpu_torch.ops.kernels import conv3d_dslice, conv3d_dslice_v2, deform_fused, fused_softargmin, prims


def kernel_wrappers() -> dict:
    """The wrapper of each kernel by its id (K1-K5, T1-T4), each carrying
    its `launches` count."""
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
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
