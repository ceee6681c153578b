"""The split-TF32 (3xTF32) arithmetic of the f32 routes of K5, K2, K1, T1
and T4 (`ops/kernels/split_f32.py`), on the CPU.

The f32 routes run their contractions on the tensor cores with each f32
operand split into two bit-masked TF32 halves. Emulated here in plain
PyTorch, each contraction at its kernel's shapes must stay within the
tolerance `chip_smoke.py` holds that kernel's f32 route to on the card
(`REL_TOL["float32"]`, `BWD_TOL["float32"]`; T1's and T4's 1e-4 of phase
9, the same as `REL_TOL["float32"]`), against f64 products of the
same seeded operands; one TF32 pass on the same operands must not (so the
split, and not the data, keeps the route inside its tolerance)."""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from dualpixelface_tpu_torch.ops.kernels.split_f32 import (
    product_1xtf32, product_3xtf32, split_planes, split_tf32, tf32_bits)
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

ROWS = 2048  # voxels of a K5 or gcols product; the voxels gw sums over


def _k5(k, rng):
    """K5: the im2col rows [voxels, 27 Cp] of x ~ N(0, 1) against the
    weight [27 Cp, 81] at chip_smoke's 1/sqrt(27 Cin) scale."""
    a = rng.standard_normal((ROWS, k))
    return a, rng.standard_normal((k, 81)) / math.sqrt(k)


def _gcols(cp, rng):
    """K2's gcols = g [voxels, 64] . W_tap^T [64, CP]."""
    return rng.standard_normal((ROWS, 64)), rng.standard_normal((64, cp)) / math.sqrt(27 * cp)


def _gw(cp, rng):
    """K2's gw^T = g^T [64, voxels] . cols [voxels, CP] (the samples, about
    0.6 of x's scale)."""
    return rng.standard_normal((64, ROWS)), rng.standard_normal((ROWS, cp)) * 0.6


def _k1(cp, rng):
    """K1: the samples [voxels, 27 CP] (about 0.6 of x's scale) against the
    taps' weight [27 CP, 64] at chip_smoke's 1/sqrt(27 Cin) scale, Cin 35
    padded to CP 40, or 64."""
    cin = {40: 35, 64: 64}[cp]
    return rng.standard_normal((ROWS, 27 * cp)) * 0.6, rng.standard_normal((27 * cp, 64)) / math.sqrt(27 * cin)


def _t1(size, rng):
    """T1: the im2col rows [voxels, 27 Cin] of x ~ N(0, 1) against the
    weight [27 Cin, Co] at `bench_dslice_fold.site_inputs`' 1/sqrt(27 Cin)
    scale; size is (Cin, Co)."""
    cin, co = size
    return rng.standard_normal((ROWS, 27 * cin)), rng.standard_normal((27 * cin, co)) / math.sqrt(27 * cin)


def _t4(k, rng):
    """T4: a [m, k] x b [k, 64], both unscaled N(0, 1), as
    `bench_vpu_prims` draws them."""
    return rng.standard_normal((ROWS, k)), rng.standard_normal((k, 64))


# (name, operands, K or CP, chip_smoke's tolerance for the result)
CASES = [
    ("K5 Cin 35 -> Cp 36", _k5, 27 * 36, chip_smoke.REL_TOL["float32"]),
    ("K5 Cp 40", _k5, 27 * 40, chip_smoke.REL_TOL["float32"]),
    ("K5 Cin 64", _k5, 27 * 64, chip_smoke.REL_TOL["float32"]),
    ("K2 gcols CP 40", _gcols, 40, chip_smoke.BWD_TOL["float32"]["gx"]),
    ("K2 gcols CP 64", _gcols, 64, chip_smoke.BWD_TOL["float32"]["gx"]),
    ("K2 gw CP 40", _gw, 40, chip_smoke.BWD_TOL["float32"]["gw"]),
    ("K2 gw CP 64", _gw, 64, chip_smoke.BWD_TOL["float32"]["gw"]),
    ("K1 CP 40", _k1, 40, chip_smoke.REL_TOL["float32"]),
    ("K1 CP 64", _k1, 64, chip_smoke.REL_TOL["float32"]),
    ("T1 K 27·32 -> 32", _t1, (32, 32), 1e-4),
    ("T1 K 27·64 -> 32", _t1, (64, 32), 1e-4),
    ("T1 K 27·64 -> 64", _t1, (64, 64), 1e-4),
    ("T4 k 2240 -> 64", _t4, 2240, 1e-4),
]


def _error_share(case, product, seed=0):
    """The largest error of `product` against f64, as a share of the
    check's tolerance (times max(1, max|ref|), as chip_smoke scales it)."""
    _, operands, size, tol = case
    a, b = operands(size, np.random.default_rng(seed))
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
    got = product(torch.from_numpy(a), torch.from_numpy(b)).double()
    return float((got - ref).abs().max()) / (tol * max(1.0, float(ref.abs().max())))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_keeps_the_f32_tolerance(case):
    # IEEE f32 sits at 0.003-0.03 of each tolerance; 3xTF32 within 2x of it
    assert _error_share(case, product_3xtf32) < 0.1


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_tf32_pass_breaks_the_f32_tolerance(case):
    assert _error_share(case, product_1xtf32) > 2.0


def test_split_halves_are_tf32_and_add_up():
    """hi and lo carry no bit below TF32's mantissa, hi + lo keeps 22 of
    f32's 24 bits, and zeros, signs and powers of two split exactly."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, -0.0, 1.0, -2.0, 0.75, 3.0e38, -3.0e-30]]).astype(np.float32))
    hi, lo = split_tf32(a)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & ((1 << 13) - 1)).any()
    assert torch.equal(tf32_bits(hi), hi) and torch.equal(hi.view(torch.int32), tf32_bits(a).view(torch.int32))
    err = (hi.double() + lo.double() - a.double()).abs()
    assert bool((err <= a.double().abs() * 2.0 ** -21).all())
    exact = torch.tensor([0.0, 1.0, -2.0, 0.75])
    assert torch.equal(split_tf32(exact)[0], exact) and not split_tf32(exact)[1].any()
    planes = split_planes(a[:4096].reshape(64, 64))
    assert planes.shape == (2, 64, 64)
    assert torch.equal(planes[0], hi[:4096].reshape(64, 64)) and torch.equal(planes[1], lo[:4096].reshape(64, 64))
