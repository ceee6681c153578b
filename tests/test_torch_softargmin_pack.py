"""The host side of K3 and K4 (`ops/kernels/fused_softargmin.py`), on the CPU.

The kernels take the D operator's taps as compile-time constants
(`static_d_taps`, csrc/fsam.cuh), each output column's weights on the three
coarse columns of its quad (`x_quad_weights`), and K4's blocks recompute
the output rows of their band of coarse rows (`band_rows`). These tests
hold those tables to the align-corners operators of `_two_taps`, and hold
a plain mirror of the kernels' arithmetic (one exp2 per bin; K3's softmax
stabilised by the max over the planes, with the largest bin where the
exps underflow, K4's by the largest bin, found among a few candidates;
K4's per-plane sums and its owner-computes reduction over bands and
quads) to the plain versions within chip_smoke.py's f32 tolerance, 1e-4
of max(1, max|plain|). The kernels' bounds (`tools.bench_softargmin.work`)
are set by their exps. Off the CPU the wrappers refuse what the kernels do
not take before anything is launched.
"""
import math

import numpy as np
import pytest
import torch

from dualpixelface_tpu_torch.ops.cost_volume import regression_disparities
from dualpixelface_tpu_torch.ops.kernels import launch_counts
from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import (
    BAND_ROWS, FACTOR, MAX_PLANES, _two_taps, band_rows, d_bins, fused_softargmin, fused_softargmin_bwd,
    fused_softargmin_bwd_plain, fused_softargmin_plain, static_d_taps, x_quad_weights)
from dualpixelface_tpu_torch.ops.resize import _linear_matrix
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

F32_TOL = 1e-4  # of max(1, max|plain|), chip_smoke.py REL_TOL["float32"]
TINY = 2.0**-90  # csrc/fsam.cuh TINY


@pytest.mark.parametrize("d", [*range(1, MAX_PLANES + 1), 17, 24, 64])
def test_static_d_taps_match_the_operator(d):
    """Each bin's first tap is the static lo plane, and its second, where
    its weight is not zero, the static hi plane; `d_bins` accepts them."""
    idx, wt = _two_taps(FACTOR * d, d)
    lo, hi = static_d_taps(d)
    np.testing.assert_array_equal(idx[:, 0], lo)
    assert np.all((wt[:, 1] == 0) | (idx[:, 1] == hi))
    bins = d_bins(d, np.arange(FACTOR * d, dtype=np.float32))
    dense = np.zeros((FACTOR * d, d), np.float32)
    np.add.at(dense, (np.arange(FACTOR * d), lo), bins[0, : FACTOR * d])
    np.add.at(dense, (np.arange(FACTOR * d), hi), bins[1, : FACTOR * d])
    np.testing.assert_array_equal(dense, _linear_matrix(FACTOR * d, d, True))


@pytest.mark.parametrize("d", range(1, MAX_PLANES + 1))
def test_the_largest_bin_is_a_candidate(d):
    """K4 shifts by the largest bin, found among the first and last bins
    between each two planes only: on random planes (and with one plane far
    above the rest) that max equals the max over every bin."""
    rng = np.random.default_rng(d)
    planes = rng.standard_normal((64, d)) * 30.0
    planes[::2, rng.integers(0, d)] += 1e3
    idx, wt = _two_taps(FACTOR * d, d)
    logits = planes[:, idx[:, 0]] * wt[:, 0] + planes[:, idx[:, 1]] * wt[:, 1]
    np.testing.assert_array_equal(logits[:, _max_bin_candidates(d)].max(axis=1), logits.max(axis=1))


@pytest.mark.parametrize("w", [1, 2, 5, 36, 144])
def test_x_quad_weights_rebuild_the_operator(w):
    """Each output column's three weights on its quad's coarse columns
    q-1, q, q+1 give back the x operator exactly, with zeros outside."""
    u = x_quad_weights(w)
    dense = np.zeros((FACTOR * w, w + 2), np.float32)  # columns -1 .. w
    for x in range(FACTOR * w):
        dense[x, x // FACTOR: x // FACTOR + 3] += u[x, :3]
    assert not dense[:, 0].any() and not dense[:, -1].any() and not u[:, 3].any()
    np.testing.assert_array_equal(dense[:, 1:-1], _linear_matrix(FACTOR * w, w, True))


@pytest.mark.parametrize("h", [5, 7, 50, 192])
def test_bands_cover_each_row_tap_once(h):
    """Every (output row, coarse row) pair with a non-zero weight falls in
    exactly one band's output rows with its coarse row in that band."""
    idx, wt = _two_taps(FACTOR * h, h)
    bands = band_rows(h, BAND_ROWS)
    assert len(bands) == math.ceil(h / BAND_ROWS)
    count = np.zeros((FACTOR * h, h), np.int64)
    for i, (first, end) in enumerate(bands):
        for y in range(first, end):
            for t in range(2):
                if wt[y, t] != 0 and idx[y, t] // BAND_ROWS == i:
                    count[y, idx[y, t]] += 1
    np.testing.assert_array_equal(count, (_linear_matrix(FACTOR * h, h, True) != 0).astype(np.int64))


def _planes(cost):
    """[B, D, 4h, 4w] f32: the planes as the kernels interpolate them, along
    y (two taps per output row), then x through the quad weights."""
    b, d, h, w = cost.shape
    idx, wt = (torch.from_numpy(a) for a in _two_taps(FACTOR * h, h))
    rows = cost.float()[:, :, idx[:, 0]] * wt[:, 0, None] + cost.float()[:, :, idx[:, 1]] * wt[:, 1, None]
    u = torch.from_numpy(x_quad_weights(w))
    cols = torch.arange(FACTOR * w) // FACTOR
    out = 0
    for c in range(3):
        col = (cols - 1 + c).clamp(0, w - 1)
        out = out + rows[..., col] * u[:, c]
    return out


def _max_bin_candidates(d):
    """The bins `shift_by_max_bin` evaluates (csrc/fsam.cuh): the first and
    last bin between each two planes, and the last bin."""
    lo, _ = static_d_taps(d)
    n = len(lo)
    return [j for j in range(n) if j in (0, n - 1) or lo[j] != lo[j - 1] or lo[j] != lo[j + 1]]


def _shifted_logits(cost, dvals, exact):
    """Each bin's logit in log2 units less K3's shift (the max over the
    planes; pixels whose exps sum below TINY shifted by their largest bin)
    or, `exact`, K4's (the largest bin among `_max_bin_candidates`), formed
    as the kernels form them: the planes shifted and scaled, then the bins
    from them."""
    d = cost.shape[1]
    bins = torch.from_numpy(d_bins(d, np.asarray(dvals, np.float32)))[:, : FACTOR * d]
    lo, hi = (torch.from_numpy(a).long() for a in static_d_taps(d))

    def logits(p):
        return bins[0, :, None, None] * p[:, lo] + bins[1, :, None, None] * p[:, hi]

    p = _planes(cost)
    top = logits((p - logits(p)[:, _max_bin_candidates(d)].amax(dim=1, keepdim=True)) * math.log2(math.e))
    if exact:
        return top, bins, lo, hi
    planes = logits((p - p.amax(dim=1, keepdim=True)) * math.log2(math.e))
    low = torch.exp2(planes).sum(dim=1, keepdim=True) < TINY
    return torch.where(low, top, planes), bins, lo, hi


def _mirror_forward(cost, dvals):
    """K3's arithmetic; past MAX_PLANES its wide form's, which shifts every
    pixel by its largest bin."""
    logits, bins, _, _ = _shifted_logits(cost, dvals, exact=cost.shape[1] > MAX_PLANES)
    e = torch.exp2(logits)
    return (e * bins[2, :, None, None]).sum(dim=1) / e.sum(dim=1)


def _mirror_backward(cost, g, dvals):
    """K4's arithmetic: per plane S0 = sum w e, S1 = sum (w dv) e over its
    bins, gd = g / sum (S1 - out S0); the quads' gd on their three columns,
    each column gathered from its own quad and its two neighbours; each band
    of coarse rows summing only its output rows (`band_rows`)."""
    b, d, h, w = cost.shape
    logits, bins, lo, hi = _shifted_logits(cost, dvals, exact=True)
    e = torch.exp2(logits)
    s0 = torch.zeros(b, d, FACTOR * h, FACTOR * w)
    s1 = torch.zeros_like(s0)
    for j in range(FACTOR * d):
        for tap, wj, wdv in ((lo[j], bins[0, j], bins[3, j]), (hi[j], bins[1, j], bins[4, j])):
            s0[:, tap] += wj * e[:, j]
            s1[:, tap] += wdv * e[:, j]
    total = s0.sum(dim=1, keepdim=True)
    out = s1.sum(dim=1, keepdim=True) / total
    gd = g.float()[:, None] / total * (s1 - out * s0)
    u = torch.from_numpy(x_quad_weights(w))
    quads = [(gd * u[:, c]).reshape(b, d, FACTOR * h, w, FACTOR).sum(-1) for c in range(3)]
    zero = torch.zeros_like(quads[0][..., :1])
    col = quads[1] + torch.cat([zero, quads[2][..., :-1]], -1) + torch.cat([quads[0][..., 1:], zero], -1)
    idx, wt = _two_taps(FACTOR * h, h)
    dcost = torch.zeros(b, d, h, w)
    for i, (first, end) in enumerate(band_rows(h, BAND_ROWS)):
        for y in range(first, end):
            for t in range(2):
                if wt[y, t] != 0 and idx[y, t] // BAND_ROWS == i:
                    dcost[:, :, idx[y, t]] += float(wt[y, t]) * col[:, :, y]
    return dcost


def _cost(seed, shape, wide, negative=-200.0):
    """Seeded logits of scale 3, or of scale 30 (`wide`) with one coarse
    cell whose planes are all near `negative` (past exp's f32 range
    unshifted) and one whose plane 3 alone is 0 and the others -3000."""
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal(shape) * (30.0 if wide else 3.0)
    if wide:
        cost[:, :, 1, 2] = negative + rng.standard_normal(shape[:2])
        cost[:, :, 4, 3] = -3000.0
        cost[:, 3, 4, 3] = 0.0
    return torch.from_numpy(cost.astype(np.float32))


def _float64_reference(cost, dvals):
    """The function in float64: the upsample through the dense operators,
    softmax, expectation."""
    b, d, h, w = cost.shape
    wd, wy, wx = (torch.from_numpy(_linear_matrix(FACTOR * n, n, True)).double() for n in (d, h, w))
    up = torch.einsum("jd,yr,xc,bdrc->bjyx", wd, wy, wx, cost.double())
    return (torch.softmax(up, dim=1) * torch.as_tensor(np.asarray(dvals)).reshape(1, -1, 1, 1)).sum(dim=1)


# D 17, 24 and 64 are the wide forms' (the backward's mirror holds there
# too: its largest bin, found among the candidates, is the largest of all)
CASES = [((2, 8, 5, 6), False), ((1, 5, 7, 4), False), ((1, 8, 9, 7), True), ((1, 16, 3, 5), False),
         ((2, 1, 6, 5), False), ((2, 17, 5, 6), False), ((1, 24, 6, 5), True), ((1, 64, 3, 4), False)]
CASE_IDS = ["D8", "D5", "D8-wide", "D16", "D1", "D17", "D24-wide", "D64"]


@pytest.mark.parametrize("shape,wide", CASES, ids=CASE_IDS)
def test_mirror_forward_matches_plain(shape, wide):
    cost = _cost(0, shape, wide)
    dv = regression_disparities(-4, 12, shape[1], 4)
    ref = fused_softargmin_plain(cost, dv)
    got = _mirror_forward(cost, dv)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= F32_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("shape,wide", CASES, ids=CASE_IDS)
def test_mirror_backward_matches_plain(shape, wide):
    cost = _cost(1, shape, wide)
    b, d, h, w = shape
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((b, 4 * h, 4 * w)).astype(np.float32))
    dv = regression_disparities(-4, 12, d, 4)
    ref = fused_softargmin_bwd_plain(cost, g, dv)
    got = _mirror_backward(cost, g, dv)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= F32_TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("negative,within", [(-200.0, True), (-1e4, False)])
def test_plain_version_is_an_oracle_down_to_some_logit_size(negative, within):
    """Why the wide cases (here and in chip_smoke.py) set the very negative
    cell near -200: there the plain version is within the f32 tolerance of
    the float64 value, so a kernel summing in another order can be held to
    it; near -1e4 its own rounding of the interpolated logits (an f32 ulp
    of 1e4 is 1e-3) already strays past the tolerance."""
    cost = _cost(0, (2, 8, 20, 16), True, negative)
    dv = regression_disparities(-4, 12, 8, 4)
    exact = _float64_reference(cost, dv)
    err = float((fused_softargmin_plain(cost, dv).double() - exact).abs().max())
    assert (err <= F32_TOL * max(1.0, float(exact.abs().max()))) == within


def test_wide_logits_need_the_exact_max():
    """The wide case really underflows: shifted by the max over the planes
    alone, some pixel's exps sum below TINY (and to 0 in f32)."""
    cost = _cost(0, (1, 8, 9, 7), True)
    p = _planes(cost)
    d = 8
    bins = torch.from_numpy(d_bins(d, np.zeros(32, np.float32)))[:, :32]
    lo, hi = (torch.from_numpy(a).long() for a in static_d_taps(d))
    q = (p - p.amax(dim=1, keepdim=True)) * math.log2(math.e)
    sums = torch.exp2(bins[0, :, None, None] * q[:, lo] + bins[1, :, None, None] * q[:, hi]).sum(dim=1)
    assert float(sums.min()) == 0.0


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_bounds_are_set_by_the_exps(kernel):
    """At the paths' shapes (K3 serving, K4 train) each kernel's exps, one
    per bin and pixel on the special-function units, take longer than its
    least f32 operations and its bytes, so they set `bound_ms`."""
    from dualpixelface_tpu_torch.tools import PEAK_BYTES, PEAK_F32, PEAK_SFU
    from dualpixelface_tpu_torch.tools.bench_softargmin import SERVE_SHAPE, TRAIN_SHAPE, bound, work

    shape = SERVE_SHAPE if kernel == "K3" else TRAIN_SHAPE
    w = work(kernel, shape)
    b, d, h, wd = shape
    assert w["exps"] == b * (FACTOR * h) * (FACTOR * wd) * FACTOR * d
    ms, _ = bound(w)
    assert ms == pytest.approx(1e3 * w["exps"] / PEAK_SFU, rel=1e-12)
    assert ms > 1e3 * max(w["flops_f32"] / PEAK_F32, w["bytes"] / PEAK_BYTES)


class _TensorOnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device (tests/test_torch_kernels.py)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("d,factor,match", [(17, 4, "32-bit indexing"), (8, 2, "upsample by 4")])
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, kernel, d, factor, match):
    """With CUDA reported available, a call on a CUDA tensor with another
    factor, or past the kernels' 32-bit indexing, raises before anything is
    built, launched or counted. D = 17, past the compiled-tap kernels' 16
    planes, is refused only for its size (2^24 batches, as meta tensors:
    nothing allocated): the wide forms take any D."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    big = match == "32-bit indexing"
    b, dev = (2**24, "meta") if big else (1, "cpu")
    cost = torch.Tensor._make_subclass(_TensorOnCuda, torch.zeros(b, d, 4, 4, device=dev))
    g = torch.Tensor._make_subclass(_TensorOnCuda, torch.zeros(b, 4 * factor, 4 * factor, device=dev))
    dv = np.linspace(-4, 12, factor * d)
    before = launch_counts()
    with pytest.raises(ValueError, match=match):
        if kernel == "K3":
            fused_softargmin(cost, dv, factor)
        else:
            fused_softargmin_bwd(cost, g, dv, factor)
    assert launch_counts() == before


def test_k4_split_patches_apply():
    """`tools.bench_k4_split` finds each text it patches in K4's source
    exactly once, and every variant's macro is in the patched source."""
    from dualpixelface_tpu_torch.tools import bench_k4_split

    source = bench_k4_split.patched()
    assert '#include "fsam.cuh"' not in source
    for flags in bench_k4_split.VARIANTS.values():
        for flag in flags:
            assert flag.removeprefix("-D").split("=")[0] in source
