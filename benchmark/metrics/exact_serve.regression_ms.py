"""Device ms a request batch of the regression (the gap from the
aggregation's end to the ANM's start): CUDA events around it on every
call of the window, their mean."""

SPANS = {"regression": ("aggregation:end", "normal_estimator:start")}


def read(r):
    return r.span_ms("regression")
