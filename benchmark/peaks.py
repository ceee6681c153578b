"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit), the roofline's yardstick."""

BF16 = 989e12        # bf16 products on the tensor cores, FLOP/s
TF32 = 495e12        # TF32 products on the tensor cores
SPLIT_TF32 = TF32 / 3  # exact f32 products as three TF32 ones (3xTF32), the fastest exact-f32 route
F32 = 67e12          # f32 arithmetic outside the tensor cores
BYTES = 3.35e12      # HBM3, bytes/s
# exp2 on the special-function units: 16 per clock per SM on sm_90, 132 SMs,
# at the 1.98 GHz boost clock behind the 67 TFLOP/s f32 peak.
SFU = 132 * 16 * 1.98e9

# The rate of a cell's products, by the precision its mix states.
PRODUCTS = {"bf16": BF16, "f32": SPLIT_TF32}


def least_seconds(parts: list[dict], precision: str) -> float:
    """The least time of a site's work: each part (one kernel's work) takes
    the larger of its bytes over the memory rate and each kind of its
    operations over that kind's peak; the parts run one after another."""
    total = 0.0
    for p in parts:
        total += max(p.get("bytes", 0.0) / BYTES, p.get("products", 0.0) / PRODUCTS[precision],
                     p.get("f32", 0.0) / F32, p.get("exps", 0.0) / SFU)
    return total
