"""Device ms a request batch of the ASM cost volume: CUDA events around it on every
call of the window, their mean."""

SPANS = {"cost_volume": ("cost_volume:start", "cost_volume:end")}


def read(r):
    return r.span_ms("cost_volume")
