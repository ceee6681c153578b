"""Device ms of the host-to-device copies of a request batch (the
Predictor casts and copies the host arrays), over the profiled slice."""


def read(r):
    return r.slice_ms_per_call("h2d_s")
