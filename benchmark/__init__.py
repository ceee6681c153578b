"""The benchmark of the PyTorch/CUDA port (`dualpixelface_tpu_torch`): data
files per cell, one harness (`python3 -m benchmark.run`) and a plain
reference that decides `correct`. See PERF.md and BENCHMARK.json."""
