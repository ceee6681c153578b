"""The whole call's share of the card's peak, in %: the FLOPs of its
products (counted from shapes over the reference) times the calls of the
window, over the window's seconds, over the peak of the mix's precision."""


def read(r):
    return r.mfu_percent()
