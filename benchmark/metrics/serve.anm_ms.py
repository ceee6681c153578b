"""Device ms a request batch of the ANM (its deformable convs and the 2-D head): CUDA events around it on every
call of the window, their mean."""

SPANS = {"normal_estimator": ("normal_estimator:start", "normal_estimator:end")}


def read(r):
    return r.span_ms("normal_estimator")
