"""Share of their roofline that the kernel sites of a train step reach
(the ANM deformable convs with their offset heads, forward and backward,
and the regression's forward), in %: the least time of their work at the
peak rates over their device time, over the profiled slice."""

SITES = [{"work": "deform", "module": "normal_estimator.deform_conv1", "backward": "deform_bwd"},
         {"work": "deform", "module": "normal_estimator.deform_conv2", "backward": "deform_bwd"},
         {"work": "regression", "from": "aggregation:end", "to": "normal_estimator:start"}]


def read(r):
    return r.roofline_percent(("deform", "deform_bwd", "regression"))
