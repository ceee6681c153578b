"""Device ms of the host-to-device copies of a train step (the step
copies the host batch in `batch_to`), over the profiled slice."""


def read(r):
    return r.slice_ms_per_call("h2d_s")
