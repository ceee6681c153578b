"""Device ms a request batch of the feature tower (FeatureExtraction): CUDA events around it on every
call of the window, their mean."""

SPANS = {"feature_extraction": ("feature_extraction:start", "feature_extraction:end")}


def read(r):
    return r.span_ms("feature_extraction")
