"""The port's 2-D deformable conv (`dualpixelface_tpu_torch/ops/deform_conv2d.py`)
against the JAX package's, on the CPU: the four cases of
tests/test_deform_conv2d.py on the port, then random offsets (a third of
them whole numbers, some past the image), mask, bias, stride 2 and
dilation 2 against JAX's `deform_conv2d`, values and the vjp, and
`DeformConvPack2D` (both variants) through `weights.state_dict_from_jax`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_zoo as zoo
from dualpixelface_tpu.ops import deform_conv2d as jax_dc
from dualpixelface_tpu_torch.ops.deform_conv2d import DeformConvPack2D, deform_conv2d
from dualpixelface_tpu_torch.weights import load_state_dict, state_dict_from_jax
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)


def _conv_nhwc(x, w_hwio, padding=1):
    """Plain cross-correlation, channels-last, by F.conv2d."""
    out = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w_hwio).permute(3, 2, 0, 1),
                   padding=padding)
    return out.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ tests/test_deform_conv2d.py's four

def test_zero_offset_equals_conv2d():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, 7, 3)).astype(np.float32)
    weight = rng.standard_normal((3, 3, 3, 4)).astype(np.float32) * 0.2
    out = deform_conv2d(torch.from_numpy(x), torch.zeros(1, 6, 7, 18), torch.from_numpy(weight))
    np.testing.assert_allclose(out.numpy(), _conv_nhwc(x, weight), rtol=1e-4, atol=1e-5)


def test_integer_offset_equals_shifted_conv():
    """A constant dy = +1 on every tap is the conv of the image shifted up
    one row (the interior rows; the border rows differ by the padding)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    weight = rng.standard_normal((3, 3, 2, 2)).astype(np.float32)
    offset = np.zeros((1, 8, 8, 18), np.float32)
    offset[..., 0::2] = 1.0
    out = deform_conv2d(torch.from_numpy(x), torch.from_numpy(offset), torch.from_numpy(weight)).numpy()
    x_shift = np.zeros_like(x)
    x_shift[:, :-1] = x[:, 1:]
    np.testing.assert_allclose(out[:, 1:-2], _conv_nhwc(x_shift, weight)[:, 1:-2], rtol=1e-4, atol=1e-5)


def test_modulated_mask_scales_output():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 5, 5, 2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 2, 2)).astype(np.float32))
    off = torch.zeros(1, 5, 5, 18)
    full = deform_conv2d(x, off, w, mask=torch.ones(1, 5, 5, 9))
    half = deform_conv2d(x, off, w, mask=torch.full((1, 5, 5, 9), 0.5))
    np.testing.assert_allclose(half.numpy(), full.numpy() * 0.5, rtol=1e-5)


@pytest.mark.parametrize("modulated", [False, True])
def test_pack_module(modulated):
    """Output shape, and the zero-initialised offset head gives zero offsets."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 3)).astype(np.float32))
    out, offset = DeformConvPack2D(3, 8, modulated=modulated, generator=torch.Generator().manual_seed(0))(x)
    assert out.shape == (1, 6, 6, 8)
    assert offset.shape == (1, 6, 6, 18)
    assert not offset.any()


# ------------------------------------------------------------ against JAX

def _random_case(seed, stride, dilation, k=3, b=2, h=9, w=11, cin=5, cout=6):
    """x, offsets (a third whole numbers; scale 2, so some samples fall
    past the image), weight, bias, mask in (0, 1), at the output size of
    the geometry with padding dilation * (k - 1) // 2."""
    rng = np.random.default_rng(seed)
    pad = dilation * (k - 1) // 2
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    offset = (2.0 * rng.standard_normal((b, ho, wo, 2 * k * k))).astype(np.float32)
    whole = rng.uniform(size=offset.shape) < 1 / 3
    offset[whole] = np.round(offset[whole])
    return {
        "x": rng.standard_normal((b, h, w, cin)).astype(np.float32),
        "offset": offset,
        "weight": (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32),
        "mask": rng.uniform(0.05, 1.0, (b, ho, wo, k * k)).astype(np.float32),
    }, pad


ARGS = ("x", "offset", "weight", "bias", "mask")


@pytest.mark.parametrize("stride, dilation, modulated", [(1, 1, False), (1, 1, True), (2, 1, True), (1, 2, False),
                                                         (2, 2, True)])
def test_deform_conv2d_and_vjp_match_jax(stride, dilation, modulated):
    """Values to 1e-5 and the vjp with respect to x, the offsets, the
    weight, the bias and the mask to 1e-5 of each one's largest entry (f32
    sums of 4 corners x 9 taps x 5 channels in another order). The whole
    offsets sit on the floor's kink, where both take the right-hand
    derivative."""
    case, pad = _random_case(10 * stride + dilation, stride, dilation)
    names = ARGS if modulated else ARGS[:-1]

    def jfn(*args):
        kw = dict(zip(names, args))
        return jax_dc.deform_conv2d(kw["x"], kw["offset"], kw["weight"], kw["bias"], kw.get("mask"),
                                    stride=stride, padding=pad, dilation=dilation)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(case[n]) for n in names))
    cot = np.random.default_rng(99).standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = {n: torch.tensor(case[n], requires_grad=True) for n in names}
    got = deform_conv2d(ts["x"], ts["offset"], ts["weight"], ts["bias"], ts.get("mask"), stride=stride,
                        padding=pad, dilation=dilation)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for n, g in zip(names, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(ts[n].grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=n)


@pytest.mark.parametrize("modulated", [False, True])
def test_pack_module_through_the_weight_bridge(modulated):
    """JAX's `DeformConvPack2D` variables, every leaf refilled from a seed
    (`torch_zoo.fill`: the offset head non-zero, so the offsets are), to the
    port's module by `state_dict_from_jax(..., model="deform_conv2d")`
    with strict=True: output and offsets to 1e-5, stride 2."""
    x = np.random.default_rng(4).standard_normal((2, 10, 12, 4)).astype(np.float32)
    jmod = jax_dc.DeformConvPack2D(6, stride=2, modulated=modulated)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = zoo.fill(shapes, np.random.default_rng(5))
    variables["params"]["conv_offset"]["kernel"] *= 4.0  # offsets of a few pixels
    want_out, want_off = jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    assert np.abs(np.asarray(want_off)).max() > 1.0
    sd = state_dict_from_jax(variables["params"], {}, model="deform_conv2d")
    port = load_state_dict(DeformConvPack2D(4, 6, stride=2, modulated=modulated), sd)
    got_out, got_off = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_off.detach().numpy(), np.asarray(want_off), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
