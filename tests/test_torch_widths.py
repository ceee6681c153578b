"""K1-K4 at widths past the committed ones, and `stereodpnet_plus` at an
`inplanes` and a `level` other than the committed 32 and 8, on the CPU.

The CUDA kernels take every width their TPU kernels take: K1 and K2 any
Cin and Co (the ANM's deform convs are Cin = inplanes + 3 and 2 inplanes,
Co = 2 inplanes), K3 and K4 any number of coarse planes (`level`). Here
their plain versions, which the card's checks hold the kernels to, against
the JAX package's: K1 and K2 at Cin 15, 96 and 131 and Co 24 and 96
against the TPU kernels `deform_conv3d_fused` and `deform_conv3d_fused_bwd`
in interpret mode (as tests/test_deform_gather_pallas.py runs them) and
against `_windowed_xla` and packed8 with their vjps; K3 and K4 at D 24
against JAX `fused_softargmin` and its gradient; and the whole model's
eval forward at `inplanes` 12, `level` 20 (its deform convs 15 -> 24 and
24 -> 24, 80 bins) against JAX's, on weights refilled from a seed
(`torch_zoo`). The same model's f32 train step is
tests/test_torch_widths_train.py's, the normal module alone at those
widths tests/test_torch_widths_anm.py's (files of their own, so that
pytest-xdist's `--dist loadfile` runs them on workers of their own).
Everything is float32; each tolerance says why it is what it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu.ops.cost_volume import regression_disparities
from dualpixelface_tpu.ops.deform_conv3d import _windowed_xla
from dualpixelface_tpu.ops.deform_conv3d import deform_conv3d as jax_deform_conv3d
from dualpixelface_tpu.ops.kernels.deform_fused import deform_conv3d_fused as jax_fused
from dualpixelface_tpu.ops.kernels.deform_fused import deform_conv3d_fused_bwd as jax_fused_bwd
from dualpixelface_tpu.ops.kernels.fused_softargmin import fused_softargmin as jax_fused_softargmin
from dualpixelface_tpu_torch.ops.kernels.deform_fused import (
    deform_conv3d_bwd, deform_conv3d_bwd_plain, deform_conv3d_fused, deform_conv3d_plain, layout)
from dualpixelface_tpu_torch.ops.kernels.fused_softargmin import (
    MAX_PLANES, fused_softargmin, fused_softargmin_bwd, fused_softargmin_plain)
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

# (Cin, Co): every one the wide form's; the interpret-mode TPU kernels take
# ~20 s a width on the CPU, so they run at three, which hold each Cin and Co
INTERPRET = [(15, 24), (96, 96), (131, 24)]
WIDTHS = INTERPRET + [(15, 96), (96, 24), (131, 96)]


def _case(cin, co, seed, shape=(1, 4, 6, 8)):
    """x, offsets (N(0, 1.5): some past the +-3 window), weight, bias and a
    cotangent, float32."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal(shape + (cin,)), rng.standard_normal(shape + (81,)) * 1.5,
              rng.standard_normal((3, 3, 3, cin, co)) / np.sqrt(27 * cin), rng.standard_normal((co,)),
              rng.standard_normal(shape + (co,)))
    return [a.astype(np.float32) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("cin,co", INTERPRET)
def test_k1_k2_plain_match_the_tpu_kernels(cin, co):
    """Windowed: K1's plain forward against the TPU kernel and its XLA twin
    to 2e-5 (f32 sums of 27 x Cin products in another order, the JAX
    suite's own bound), and K2's plain backward against the TPU backward
    kernel to 3e-4 of each gradient's largest entry (its per-block weight
    sums, the JAX suite's bound)."""
    assert layout(cin, co)[0]
    x, off, w, bias, g = _case(cin, co, seed=cin + co)
    jx = [jnp.asarray(a) for a in (x, off, w, bias, g)]
    got = deform_conv3d_fused(*_t(x, off, w, bias), aperture=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused(*jx[:4], interpret=True)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_windowed_xla(*jx[:4])), rtol=2e-5, atol=2e-5)
    ref = jax_fused_bwd(*jx, interpret=True)
    for name, a, r in zip(("gx", "goff", "gw", "gb"), deform_conv3d_bwd(*_t(x, off, w, bias, g), aperture=True), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=3e-4 * max(1.0, np.abs(r).max()), err_msg=name)


@pytest.mark.parametrize("aperture", [True, False])
@pytest.mark.parametrize("cin,co", WIDTHS)
def test_k1_k2_plain_match_the_xla_vjp(cin, co, aperture):
    """K1's and K2's plain versions against JAX's windowed twin (aperture)
    or packed8 (none) and `jax.vjp` of it, to 1e-5 of each result's
    largest entry: f32 sums in another order."""
    x, off, w, bias, g = _case(cin, co, seed=2 * cin + co)
    fn = _windowed_xla if aperture else (lambda *a: jax_deform_conv3d(*a, impl="packed8"))
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, off, w, bias)))
    got = deform_conv3d_plain(*_t(x, off, w, bias), aperture).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * np.abs(np.asarray(want)).max())
    ref = vjp(jnp.asarray(g))
    for name, a, r in zip(("gx", "goff", "gw", "gb"), deform_conv3d_bwd_plain(*_t(x, off, w, bias, g), aperture), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("b,d,h,w", [(2, 24, 8, 6), (1, 24, 16, 9)])  # JAX's: 4h a multiple of 32
def test_k3_k4_plain_match_jax_at_24_planes(b, d, h, w):
    """K3's and K4's plain versions at 24 coarse planes (96 bins, past the
    compiled-tap kernels' MAX_PLANES) against JAX `fused_softargmin` and
    its gradient, to 1e-4 (the same operator applied dense in JAX, by two
    taps in the port: f32 sums in another order), and the differentiable
    wrapper against the plain backward."""
    assert d > MAX_PLANES
    rng = np.random.default_rng(d + h)
    cost = (rng.standard_normal((b, d, h, w)) * 3.0).astype(np.float32)
    g = rng.standard_normal((b, 4 * h, 4 * w)).astype(np.float32)
    dv = regression_disparities(-4, 12, d, 4)
    want = np.asarray(jax_fused_softargmin(jnp.asarray(cost), dv, factor=4))
    np.testing.assert_allclose(fused_softargmin_plain(*_t(cost), dv).numpy(), want, rtol=1e-4, atol=1e-4)
    ref = jax.grad(lambda c: jnp.sum(jax_fused_softargmin(c, dv, factor=4) * jnp.asarray(g)))(jnp.asarray(cost))
    got = fused_softargmin_bwd(*_t(cost, g), dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    leaf = torch.from_numpy(cost).requires_grad_(True)
    (fused_softargmin(leaf, dv) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ the model

MODEL = "stereodpnet_plus"
OVER = {"inplanes": 12, "level": 20}


def _noisy_offsets(variables, popt):
    """The deform offset heads refilled non-zero (seeded: at the JAX init
    they are zero and the deform convs would sample only the grid)."""
    rng = np.random.default_rng(31)
    for i in (1, 2):
        off = variables["params"]["normal_estimator"][f"deform_conv{i}"]["conv_offset"]
        off["kernel"] = off["kernel"] * 3.0
        off["bias"] = rng.standard_normal(off["bias"].shape).astype(np.float32)
    return variables


def test_stereodpnet_plus_eval_at_inplanes_12_level_20_matches_jax():
    """The eval forward (batch 2, 64x64) on seeded weights with non-zero
    offset heads: every result key within `torch_zoo.check_eval`'s
    tolerances; the deform convs are 15 -> 24 and 24 -> 24, the
    regression 80 bins."""
    ref, got = zoo.eval_pair(MODEL, OVER, adjust=_noisy_offsets)
    hw = zoo.size_of(MODEL)
    zoo.check_eval(ref, got, {"pred_depth": (2, 1, hw, hw), "pred_normal": (2, 1, hw, hw, 3),
                              "ref_feature": (2, hw // 4, hw // 4), "prob_depth": None})
