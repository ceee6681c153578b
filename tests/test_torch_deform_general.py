"""The port's whole 3-D deformable conv surface (`dualpixelface_tpu_torch/
ops/deform_conv3d.py`) against the JAX package's, on the CPU.

`deform_conv3d` at three geometries other than the ANM's (3x3x3 / stride
1 / pad 1 / dilation 1), each impl, with and without `aperture` and
`gather_chunks`: values against JAX `deform_conv3d` and
tests/test_deform_conv3d.py's naive oracle, the vjp against JAX's;
which route each geometry takes (the kernels' at the ANM geometry at every
width, the plain gather elsewhere); `expand_masked_offset` for every
`dimension`; `DeformConv3D`, `DeformConvPack3D_d` and `DeformConvPack3D`
at stride 2 through `weights.state_dict_from_jax(..., model="deform_conv3d")`
with non-zero offset heads. Inputs and weights are made with numpy from
seeds; everything is float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu.ops import deform_conv3d as jax_dc
from dualpixelface_tpu_torch.ops import deform_conv3d as dc
from dualpixelface_tpu_torch.weights import load_state_dict, state_dict_from_jax
from test_deform_conv3d import naive_deform_conv3d
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

# (kernel_size, stride, padding, dilation): none the ANM's
GEOMETRIES = {
    "k3-s2-p2-d2": ((3, 3, 3), 2, 2, 2),
    "k133-p011": ((1, 3, 3), 1, (0, 1, 1), 1),
    "k232-s121-d112": ((2, 3, 2), (1, 2, 1), (0, 1, 1), (1, 1, 2)),
}
# (aperture, gather_chunks) per impl: both off, then both on
OPTIONS = [(False, 1), (True, 3)]


def _case(geometry, seed, b=1, dhw=(4, 7, 6), cin=3, cout=4):
    """Seeded x, offsets (N(0, 1.2), a third of them whole numbers, on the
    floor's kink where both take the right-hand derivative), weight and
    bias for `geometry`, and the output's shape."""
    ks, st, pad, dil = (dc._triple(v) for v in geometry)
    rng = np.random.default_rng(seed)
    out = tuple((n + 2 * p - q * (k - 1) - 1) // s + 1 for n, p, q, k, s in zip(dhw, pad, dil, ks, st))
    k = int(np.prod(ks))
    off = rng.standard_normal((b,) + out + (3 * k,)) * 1.2
    off = np.where(rng.random(off.shape) < 1 / 3, np.round(off), off)
    arrays = (rng.standard_normal((b,) + dhw + (cin,)), off, rng.standard_normal(ks + (cin, cout)) * 0.2,
              rng.standard_normal((cout,)))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("impl", ["simple", "packed", "packed8"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_deform_conv3d_and_vjp_match_jax(geometry, impl):
    """Values to 1e-5 of JAX's (and, unclamped, of the naive oracle's) and
    the vjp in x, the offsets, the weight and the bias to 1e-5 of each
    one's largest entry: f32 sums of 8 corners x K taps x 3 channels in
    another order. `aperture` clamps as JAX's 'packed' and 'packed8' do
    ('simple' ignores it, in both); `gather_chunks` changes nothing."""
    ks, st, pad, dil = GEOMETRIES[geometry]
    assert dc.route(ks, st, pad, dil) == "plain"
    x, off, w, bias = _case(GEOMETRIES[geometry], seed=len(geometry) + len(impl))
    oracle = naive_deform_conv3d(x, off, w, bias, *(int(np.asarray(v).flat[0]) for v in (st, pad, dil))) \
        if all(np.ndim(v) == 0 for v in (st, pad, dil)) else None
    for aperture, chunks in OPTIONS:
        def jfn(*a):
            return jax_dc.deform_conv3d(*a, stride=st, padding=pad, dilation=dil, impl=impl, aperture=aperture,
                                        gather_chunks=chunks)

        want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, off, w, bias)))
        cot = np.random.default_rng(7).standard_normal(want.shape).astype(np.float32)
        want_grads = vjp(jnp.asarray(cot))
        ts = [torch.tensor(a, requires_grad=True) for a in (x, off, w, bias)]
        got = dc.deform_conv3d(*ts, stride=st, padding=pad, dilation=dil, impl=impl, aperture=aperture,
                               gather_chunks=chunks)
        got.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        if oracle is not None and not (aperture and impl != "simple"):
            np.testing.assert_allclose(got.detach().numpy(), oracle, rtol=1e-4, atol=1e-4)
        for name, t, g in zip(("x", "offset", "weight", "bias"), ts, want_grads):
            g = np.asarray(g)
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_aperture_binds_at_a_general_geometry():
    """The offsets of `_case` reach past the +-3 window: with `aperture`
    'packed8' samples otherwise than without (the test above holds both)."""
    ks, st, pad, dil = GEOMETRIES["k133-p011"]
    x, off, w, bias = (torch.from_numpy(a) for a in _case(GEOMETRIES["k133-p011"], seed=3))
    off = off * 4.0
    a, b = (dc.deform_conv3d(x, off, w, bias, st, pad, dil, impl="packed8", aperture=ap) for ap in (True, False))
    assert not torch.equal(a, b)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append(kwargs.get("aperture"))
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("cin,cout", [(15, 24), (96, 96), (131, 16)])
def test_the_anm_geometry_takes_the_kernels_at_every_width(monkeypatch, cin, cout):
    """At 3x3x3 / s1 / p1 / d1 every impl goes through `deform_conv3d_fused`
    (K1 and K2 on the card) at any width, windowed for 'pallas' and for
    `aperture` with 'packed' or 'packed8'; the plain route is never taken.
    The values equal JAX's windowed twin or packed8 to 1e-5."""
    spy = _Spy(dc.deform_conv3d_fused)
    monkeypatch.setattr(dc, "deform_conv3d_fused", spy)
    monkeypatch.setattr(dc._PlainDeformConv3d, "apply", lambda *a: pytest.fail("plain route at the ANM geometry"))
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((1, 2, 5, 4, cin)).astype(np.float32)
    off = (rng.standard_normal((1, 2, 5, 4, 81)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    want = {True: jax_dc._windowed_xla(*(jnp.asarray(a) for a in (x, off, w)), None),
            False: jax_dc.deform_conv3d(*(jnp.asarray(a) for a in (x, off, w)), None, impl="packed8")}
    cases = [("simple", True, False), ("packed", False, False), ("packed8", True, True), ("pallas", False, True)]
    for impl, aperture, windowed in cases:
        got = dc.deform_conv3d(*(torch.from_numpy(a) for a in (x, off, w)), impl=impl, aperture=aperture,
                               gather_chunks=3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[windowed]), rtol=1e-5, atol=1e-5, err_msg=impl)
    assert spy.calls == [c[2] for c in cases]


@pytest.mark.parametrize("geometry", [*GEOMETRIES, "anm"])
def test_route_depends_on_the_geometry_alone(geometry):
    ks, st, pad, dil = GEOMETRIES.get(geometry, ((3, 3, 3), 1, 1, 1))
    assert dc.route(ks, st, pad, dil) == ("kernels" if geometry == "anm" else "plain")
    if geometry != "anm":
        x, off, w, bias = (torch.from_numpy(a) for a in _case(GEOMETRIES[geometry], seed=1))
        with pytest.raises(ValueError, match="pallas"):
            dc.deform_conv3d(x, off, w, bias, st, pad, dil, impl="pallas")


@pytest.mark.parametrize("dimension", ["T", "H", "W", "TH", "TW", "HW", "THW", "WH", "WT"])
def test_expand_masked_offset_matches_jax(dimension):
    length = len(set(dimension))
    temp = np.random.default_rng(len(dimension)).standard_normal((2, 3, length * 18)).astype(np.float32)
    want = np.asarray(jax_dc.expand_masked_offset(jnp.asarray(temp), dimension, 18))
    got = dc.expand_masked_offset(torch.from_numpy(temp), dimension, 18).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        dc.expand_masked_offset(torch.from_numpy(temp[..., 1:]), dimension, 18)


def _jax_module_case(jmod, args, seed, offset_scale=4.0):
    """JAX variables for `jmod`, every leaf refilled from a seed
    (`torch_zoo.fill`), the offset head scaled so the offsets reach a few
    voxels; the output and the gradients of sum(out * cot) in the inputs
    and the parameters."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = zoo.fill(shapes, np.random.default_rng(seed))
    if "conv_offset" in variables["params"]:
        variables["params"]["conv_offset"]["kernel"] *= offset_scale
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    out = jmod.apply({"params": params}, *args)
    out = out[0] if isinstance(out, tuple) else out
    cot = np.random.default_rng(seed + 1).standard_normal(out.shape).astype(np.float32)

    def loss(p, *a):
        o = jmod.apply({"params": p}, *a)
        return jnp.sum((o[0] if isinstance(o, tuple) else o) * cot)

    grads = jax.grad(loss, argnums=tuple(range(len(args) + 1)))(params, *args)
    return variables, np.asarray(out), cot, grads


def _check_module(port, variables, targs, want, cot, grads):
    """Output to 1e-5; the gradients of the inputs and of every parameter
    (mapped to the reference names) to 1e-5 of each one's largest entry."""
    got = port(*targs)
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(cot))
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads[0]), {}, model="deform_conv3d")
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0, atol=1e-5 * np.abs(ref[name]).max(),
                                   err_msg=name)
    for t, g in zip(targs, grads[1:]):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_deform_conv3d_module_through_the_weight_bridge():
    """JAX's `DeformConv3D(dimension="HW")` (external offsets, dT pinned to
    zero), kernel (1, 3, 3), stride (1, 2, 2), pad (0, 1, 1), dilation
    (1, 2, 1), with the bias: the port's module by `state_dict_from_jax`
    with strict=True."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 8, 7, 5)).astype(np.float32)
    kw = dict(kernel_size=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1), dilation=(1, 2, 1), dimension="HW")
    jmod = jax_dc.DeformConv3D(6, **kw)
    out_dhw = (3, 3, 4)
    off = (rng.standard_normal((2,) + out_dhw + (2 * 9,)) * 1.5).astype(np.float32)
    variables, want, cot, grads = _jax_module_case(jmod, (jnp.asarray(x), jnp.asarray(off)), seed=12)
    port = load_state_dict(dc.DeformConv3D(5, 6, **kw), state_dict_from_jax(variables["params"], {},
                                                                            model="deform_conv3d"))
    targs = [torch.tensor(a, requires_grad=True) for a in (x, off)]
    _check_module(port, variables, targs, want, cot, grads)


@pytest.mark.parametrize("dimension", ["T", "HW"])
def test_deform_pack_d_through_the_weight_bridge(dimension):
    """JAX's `DeformConvPack3D_d` with a non-zero offset head of
    len(dimension) x 27 channels, 3x3x3 at stride 2: output and every
    gradient; the port's head is zero at init, as JAX's."""
    x = np.random.default_rng(13).standard_normal((1, 5, 9, 8, 4)).astype(np.float32)
    jmod = jax_dc.DeformConvPack3D_d(6, stride=2, dimension=dimension)
    variables, want, cot, grads = _jax_module_case(jmod, (jnp.asarray(x),), seed=14)
    fresh = dc.DeformConvPack3D_d(4, 6, stride=2, dimension=dimension)
    assert not fresh.conv_offset.weight.any() and fresh.conv_offset.weight.shape[0] == len(dimension) * 27
    port = load_state_dict(fresh, state_dict_from_jax(variables["params"], {}, model="deform_conv3d"))
    _check_module(port, variables, [torch.tensor(x, requires_grad=True)], want, cot, grads)


def test_deform_pack_at_stride_2_through_the_weight_bridge():
    """JAX's `DeformConvPack3D(stride=2)` (its offset head an `nn.Conv`,
    'pallas' downgraded to 'packed8'): output, offsets and every gradient;
    `offset_clamp` does nothing outside the ANM geometry, in both."""
    x = np.random.default_rng(15).standard_normal((1, 4, 9, 8, 4)).astype(np.float32)
    jmod = jax_dc.DeformConvPack3D(6, stride=2, impl="pallas", offset_clamp=True)
    variables, want, cot, grads = _jax_module_case(jmod, (jnp.asarray(x),), seed=16)
    want_off = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))[1])
    assert np.abs(want_off).max() > 3.0
    port = load_state_dict(dc.DeformConvPack3D(4, 6, "pallas", True, stride=2, maxsize=2.0),
                           state_dict_from_jax(variables["params"], {}, model="deform_conv3d"))
    assert not port.anm
    np.testing.assert_allclose(port(torch.from_numpy(x))[1].detach().numpy(), want_off, rtol=1e-5, atol=1e-5)
    _check_module(port, variables, [torch.tensor(x, requires_grad=True)], want, cot, grads)


@pytest.mark.parametrize("impl", ["pallas", "packed8"])
def test_deform_pack_at_the_anm_geometry_and_another_width(impl):
    """The ANM geometry at Cin 15, Co 24 (`inplanes` 12's second conv is
    24 -> 24): the offset head through K5's plain version, the conv
    through K1's, D = 4 windowed under 'pallas'; output and offsets to
    1e-5 of JAX's."""
    x = np.random.default_rng(17).standard_normal((1, 4, 6, 5, 15)).astype(np.float32)
    jmod = jax_dc.DeformConvPack3D(24, impl=impl)
    variables, want, cot, grads = _jax_module_case(jmod, (jnp.asarray(x),), seed=18, offset_scale=8.0)
    port = load_state_dict(dc.DeformConvPack3D(15, 24, impl),
                           state_dict_from_jax(variables["params"], {}, model="deform_conv3d"))
    assert port.anm
    got, off = port(torch.from_numpy(x))
    want_off = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))[1])
    np.testing.assert_allclose(off.detach().numpy(), want_off, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
