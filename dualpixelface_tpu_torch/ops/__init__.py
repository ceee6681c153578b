"""Operators of the port: blocks, resizes, geometry, cost volumes, ASM,
aggregation, deformable conv, and the CUDA kernels under `kernels/`."""
