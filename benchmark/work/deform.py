"""The least work of one call of the ANM's deformable conv site
(DeformConvPack3D's forward): its offset head, a dense 3x3x3 conv to 81
channels (kernel K5 in the program), and the deformable conv itself (K1).
Each input byte is read once and each output byte written once; an FMA is
two operations, as the peak rates count them."""

# f32 operations per (voxel, tap, input channel) outside the products: the
# trilinear sample from its 8 corners, 1 multiply + 7 FMA; the per-(voxel,
# tap) positions and corner weights are shared by the channels and left out.
K1_F32_OPS = 15
OFFSETS = 81  # 3 offsets for each of the 27 taps


def work(shape, itemsize: int, co: int, image=None) -> list[dict]:
    """x [B, D, H, W, Cin] of `itemsize` bytes an element, Co outputs."""
    b, d, h, w, cin = shape
    m = b * d * h * w
    x = m * cin * itemsize
    head = {"bytes": x + (27 * cin + 1) * OFFSETS * itemsize + m * OFFSETS * itemsize,
            "products": 2.0 * m * 27 * cin * OFFSETS}
    conv = {"bytes": x + m * OFFSETS * itemsize + (27 * cin + 1) * co * itemsize + m * co * itemsize,
            "products": 2.0 * m * 27 * cin * co, "f32": K1_F32_OPS * m * 27 * cin}
    return [head, conv]
