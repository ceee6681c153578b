"""The port's on-device affine metrics (`metrics_torch`) against the JAX
package's `metrics_jax`, on the CPU.

Inputs are made with numpy from a seed, as tests/test_affine_dp_jax.py
makes them: a tie-free case, a quantised one full of ties, a perfect
affine fit, a border of zero confidence and a bf16 prediction. Both twins
compute in float32 with the same closed-form fits and the same stable
ranks, so they agree to float32 rounding: atol 1e-6, rtol 1e-5 (sums in
another order). Against the numpy `metrics` (float64, and an unstable
argsort), only on tie-free inputs, at the JAX test's own rtol 2e-3,
atol 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualpixelface_tpu.metrics.affine_dp import metrics as jax_pack_metrics
from dualpixelface_tpu.metrics.affine_dp import metrics_jax
from dualpixelface_tpu_torch.metrics.affine_dp import metrics, metrics_torch
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)


def _recipe(seed, b=3, h=24, w=24):
    """tests/test_affine_dp_jax.py's inputs: depth U(0.5, 2), the prediction
    an affine map of it with noise, a random mask as confidence."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 2.0, (b, h, w)).astype(np.float32)
    pred = 3.0 * depth + 0.7 + rng.normal(0, 0.1, depth.shape).astype(np.float32)
    conf = (rng.random((b, h, w)) > 0.2).astype(np.float32)
    return pred, depth, conf


def _tie_free(seed):
    return _recipe(seed)


def _ties(seed):
    """The prediction rounded to 1/4 and the depth to 1/8: most values are
    shared by many pixels, so the ranks depend on how ties are broken."""
    pred, depth, conf = _recipe(seed)
    return np.round(pred * 4) / 4, np.round(depth * 8) / 8, conf


def _perfect(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 2.0, (2, 16, 16)).astype(np.float32)
    return 2.0 * depth + 0.1, depth, np.ones_like(depth)


def _zero_border(seed):
    pred, depth, conf = _recipe(seed, b=2, h=32, w=24)
    conf[:, :3], conf[:, -3:], conf[:, :, :3], conf[:, :, -3:] = 0, 0, 0, 0
    return pred, depth, conf


CASES = {"tie-free": _tie_free, "ties": _ties, "perfect-fit": _perfect, "zero-border": _zero_border}
TIE_FREE = ("tie-free", "perfect-fit", "zero-border")


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_torch_matches_metrics_jax(case):
    pred, depth, conf = (a.astype(np.float32) for a in CASES[case](seed=len(case)))
    want = np.asarray(metrics_jax(jnp.asarray(pred), jnp.asarray(depth), jnp.asarray(conf)))
    got = metrics_torch(torch.from_numpy(pred), torch.from_numpy(depth), torch.from_numpy(conf))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if case == "ties":
        assert len(np.unique(pred)) < pred.size // 50
    if case == "perfect-fit":
        assert (got.numpy() < 1e-3).all()
    if case in TIE_FREE:
        ref = metrics(pred, depth, conf)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-4)
        # the port's numpy pack is the JAX package's
        np.testing.assert_allclose(ref, jax_pack_metrics(pred, depth, conf), rtol=0, atol=0)


def test_metrics_torch_widens_a_bf16_prediction():
    """A bf16 prediction (as the serving path returns it) is widened to
    float32 first, as `metrics_jax` does with a bf16 array: the same bf16
    values through both."""
    pred, depth, conf = _recipe(seed=5)
    pred16 = torch.from_numpy(pred).bfloat16()
    want = np.asarray(metrics_jax(jnp.asarray(pred16.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(depth),
                                  jnp.asarray(conf)))
    got = metrics_torch(pred16, torch.from_numpy(depth), torch.from_numpy(conf))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ranks_break_ties_in_index_order():
    """The ranks are the stable double argsort's: tied values rank in the
    order of their index, as `jnp.argsort` ranks them."""
    from dualpixelface_tpu_torch.metrics.affine_dp import _ranks

    z = torch.tensor([[2.0, 1.0, 2.0, 1.0, 0.0, 2.0]])
    assert _ranks(z).tolist() == [[3, 1, 4, 2, 0, 5]]
    assert _ranks(-z).tolist() == [[0, 3, 1, 4, 5, 2]]
