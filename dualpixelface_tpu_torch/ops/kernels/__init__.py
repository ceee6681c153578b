"""Hand-written CUDA kernels for Hopper, one per TPU Pallas kernel on the
serving path. Each module holds the wrapper (kernel for CUDA tensors, plain
PyTorch version for CPU tensors), the plain version and a launch counter;
the CUDA sources are in `dualpixelface_tpu_torch/csrc/`."""
from dualpixelface_tpu_torch.ops.kernels import conv3d_dslice, deform_fused, fused_softargmin


def kernel_wrappers():
    """The three wrappers, each carrying its `launches` count."""
    return (
        deform_fused.deform_conv3d_fused,
        fused_softargmin.fused_softargmin,
        conv3d_dslice.conv3d_dslice,
    )


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0
