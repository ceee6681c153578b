"""Device ms a request batch of NNet's 3-D stack (dres0-dres4 and the
classifier): the program's `model.aggregation` span
(`models/nnet/mainmodel.NNET.forward`), its CUDA events over the window's
calls of `serve.call` (`benchmark/program_spans.py`)."""
from benchmark.program_spans import device_ms_per_call


def read(r):
    return device_ms_per_call("model.aggregation")
