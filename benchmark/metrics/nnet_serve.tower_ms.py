"""Device ms a request batch of NNet's feature tower (PSMNet's SPP tower,
once per view): the program's `model.feature_extraction` span
(`models/nnet/mainmodel.NNET.forward`), its CUDA events over the window's
calls of `serve.call` (`benchmark/program_spans.py`)."""
from benchmark.program_spans import device_ms_per_call


def read(r):
    return device_ms_per_call("model.feature_extraction")
