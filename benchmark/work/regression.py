"""The least work of one call of the regression site, from the logits it
takes, [B, D, h, w]:
  * coarse (`stereodpnet_plus`, kernel K3): the x4 align-corners trilinear
    upsample and the soft-argmin over the 4D bins, fused. f32 operations
    per output pixel: per plane, the separable interpolation, 3 along x (a
    multiply and an FMA) and 3 along y shared by the 4 pixels on the same
    coarse columns (0.75), then the shift, a max and a subtraction (2); per
    bin, its 2-tap logit (3), the sum of the exps and an FMA of each with
    its value (3); one division;
  * already upsampled (`stereodpnet`, whose aggregation upsamples; the
    logits then have the image's height and width): the
    soft-argmin alone over the D bins, which also writes the
    probabilities. Per pixel and bin: a max, a subtraction, the sum of the
    exps, the normalisation and an FMA with its value (6); one division.
Each input byte is read once and each output byte written once."""

FACTOR = 4


def note(module, args, output):
    """The range's shapes, from the aggregation's output: each head's
    logits [B, D, h, w] (one head in eval, three in training)."""
    heads = output[0]
    return tuple(heads[0].shape), heads[0].dtype, None, len(heads)


def work(shape, itemsize: int, co=None, image=None) -> list[dict]:
    b, d, h, w = shape
    if image is not None and (h, w) == tuple(image):
        npix = b * h * w
        return [{"bytes": 2 * npix * d * itemsize + npix * itemsize, "f32": npix * (6.0 * d + 1.0),
                 "exps": npix * d}]
    npix = b * FACTOR * FACTOR * h * w
    return [{"bytes": b * d * h * w * itemsize + npix * itemsize,
             "f32": npix * (d * 5.75 + FACTOR * d * 6.0 + 1.0), "exps": npix * FACTOR * d}]
