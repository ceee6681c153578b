"""Share of the profiled slice's wall in which no operation ran on the
card, in %."""


def read(r):
    return r.idle_percent()
