"""Peak device memory allocated over the window, in GB (1e9 bytes)."""


def read(r):
    return r.peak_gb()
