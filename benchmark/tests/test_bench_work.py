"""The kernel sites' work counts give PERF.md's bounds at its shapes, and
the FLOP count of a call is what its shapes say."""
from __future__ import annotations

import pytest

from benchmark import peaks, spec
from benchmark.work.flops import step_flops

SERVE_ANM = (4, 4, 192, 144)   # batch 4, the ANM's 4 planes at 768x576 / 4
TRAIN_ANM = (2, 4, 192, 144)   # the bf16 train step's batch 2
CINS = (35, 64)


def _ms(site, shape, precision="bf16", co=64, pick=None, image=(768, 576)):
    parts = spec.site_work(site)(shape, 2 if precision == "bf16" else 4, co, image)
    return 1e3 * peaks.least_seconds(parts if pick is None else [parts[pick]], precision)


@pytest.mark.parametrize("row, site, shape, pick, bound", [
    ("K1", "deform", SERVE_ANM, 1, 0.265),
    ("K5", "deform", SERVE_ANM, 0, 0.194),
    ("K2", "deform_bwd", TRAIN_ANM, 0, 0.468),
])
def test_deform_bounds_match_perf_md(row, site, shape, pick, bound):
    total = sum(_ms(site, shape + (cin,), pick=pick) for cin in CINS)
    assert total == pytest.approx(bound, abs=0.0015), row


def test_softargmin_bounds_match_perf_md():
    assert _ms("regression", (4, 8, 192, 144)) == pytest.approx(0.0135, abs=0.0002)
    assert _ms("regression_bwd", (2, 8, 192, 144)) == pytest.approx(0.0068, abs=0.0002)


def test_upsampled_regression_reads_and_writes_the_full_volume():
    """stereodpnet's soft-argmin on [4, 32, 768, 576] f32 logits, which it
    reads and writes back as probabilities, with the disparity: 460 MB at
    3.35 TB/s. Logits of the image's size are taken as upsampled."""
    assert _ms("regression", (4, 32, 768, 576), "f32") == pytest.approx(0.1373, abs=0.0005)
    assert _ms("regression", (4, 32, 768, 576), "f32", image=(3072, 2304)) > 2 * 0.1373


def test_f32_products_count_at_the_split_tf32_rate():
    k5 = sum(_ms("deform", (4, 4, 192, 144, cin), "f32", pick=0) for cin in CINS)
    assert k5 == pytest.approx(1.161, abs=0.002)  # PERF.md's split bound of K5 f32


def _sized(name, **size):
    cell = spec.cell(name)
    cell.mix = dict(cell.mix, **size)
    return cell


def test_step_flops_scale_with_the_shapes():
    size = {"batch": 1, "height": 64, "width": 48}
    one = step_flops(_sized("stereodpnet_plus.serve.bf16.b4", **size))
    two = step_flops(_sized("stereodpnet_plus.serve.bf16.b4", **dict(size, batch=2)))
    assert one > 0 and two == pytest.approx(2 * one)
    assert step_flops(_sized("stereodpnet_plus.train.f32.b8", **size)) > 2 * one
