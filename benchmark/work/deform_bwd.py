"""The least work of the backward of one call of the ANM's deformable conv
site: the deformable conv's gradients gx, goff and gw (kernel K2 in the
program) and its offset head's input and weight gradients."""

# f32 operations per (voxel, tap, input channel) outside the products: the
# sample and its 3 position derivatives, factorised (31), each corner's
# share of gx (16), goff's sums over the channels (6).
K2_F32_OPS = 53
OFFSETS = 81


def work(shape, itemsize: int, co: int, image=None) -> list[dict]:
    """x [B, D, H, W, Cin] of `itemsize` bytes an element, Co outputs."""
    b, d, h, w, cin = shape
    m = b * d * h * w
    x, off, wt = m * cin * itemsize, m * OFFSETS * itemsize, 27 * cin * co * itemsize
    k2 = {"bytes": 2 * (x + off + wt) + m * co * itemsize,
          "products": 2 * 2.0 * m * 27 * cin * co, "f32": K2_F32_OPS * m * 27 * cin}
    head = {"bytes": 2 * (x + 27 * cin * OFFSETS * itemsize) + off,
            "products": 2 * 2.0 * m * 27 * cin * OFFSETS}
    return [k2, head]
