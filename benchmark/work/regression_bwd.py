"""The least work of the backward of the fused regression (kernel K4 in
the program): the coarse logits and the disparity's cotangent read, the
logits' gradient written. f32 operations per output pixel: per plane the
interpolation as in the forward (5.75), the plane sums' totals (2), its
gradient g/sum (S1 - out S0) (3) and the transposed interpolation (5);
per bin its logit and an FMA of its exp into the two planes' sums of w e
and w dv e (11); per pixel the reciprocal, out and g/sum (3)."""

FACTOR = 4


def work(shape, itemsize: int, co=None, image=None) -> list[dict]:
    b, d, h, w = shape
    npix = b * FACTOR * FACTOR * h * w
    return [{"bytes": 2 * b * d * h * w * itemsize + npix * itemsize,
             "f32": npix * (d * (5.75 + 2.0 + 3.0 + 5.0) + FACTOR * d * 11.0 + 3.0), "exps": npix * FACTOR * d}]
