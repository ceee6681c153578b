"""Device ms a request batch of the hourglass aggregation: CUDA events around it on every
call of the window, their mean."""

SPANS = {"aggregation": ("aggregation:start", "aggregation:end")}


def read(r):
    return r.span_ms("aggregation")
