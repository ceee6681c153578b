"""Device ms a request batch of NNet's normal module (the world-coordinate
volume, the plane pools, the dilated 2-D stack): the program's
`model.normal_estimator` span (`models/nnet/mainmodel.NNET.forward`), its
CUDA events over the window's calls of `serve.call`
(`benchmark/program_spans.py`)."""
from benchmark.program_spans import device_ms_per_call


def read(r):
    return device_ms_per_call("model.normal_estimator")
