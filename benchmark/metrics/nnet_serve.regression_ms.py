"""Device ms a request batch of NNet's regression (both heads' x4 trilinear
resize and soft-argmin): the program's `model.regression` span
(`models/nnet/mainmodel.NNET.forward`), its CUDA events over the window's
calls of `serve.call` (`benchmark/program_spans.py`)."""
from benchmark.program_spans import device_ms_per_call


def read(r):
    return device_ms_per_call("model.regression")
