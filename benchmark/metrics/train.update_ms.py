"""Device ms a train step of the optimizer update: between the step's own marks, on
every step of the window, their mean."""


def read(r):
    return r.span_ms("update")
