"""The PyTorch port's modules against their JAX counterparts, on the CPU.

One seeded numpy weight tree (shapes from the JAX model, inplanes 8 so the
test stays small) feeds both sides: the JAX modules apply its subtrees, and
the port's model loads it through `weights.state_dict_from_jax` with
strict=True. Inputs are made with numpy from a seed. Comparisons are in
float32; each tolerance says why it is what it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.config import Configuration
from dualpixelface_tpu.models import model_selector as jax_model_selector
from dualpixelface_tpu.models.stereodpnet import normal_module as jax_nm
from dualpixelface_tpu.models.stereodpnet.modules import ASMCostVolume as JaxASMCostVolume
from dualpixelface_tpu.models.stereodpnet.modules import FeatureExtraction as JaxFeatureExtraction
from dualpixelface_tpu.ops import asm as jax_asm
from dualpixelface_tpu.ops import blocks as jax_blocks
from dualpixelface_tpu.ops import resize as jax_resize
from dualpixelface_tpu.ops.aggregation import PSMNetHGAggregation as JaxAggregation
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.models.stereodpnet import normal_module as pt_nm
from dualpixelface_tpu_torch.ops import asm as pt_asm
from dualpixelface_tpu_torch.ops import blocks as pt_blocks
from dualpixelface_tpu_torch.ops import resize as pt_resize
from dualpixelface_tpu_torch.weights import load_state_dict, state_dict_from_jax
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

C = 8  # inplanes: narrow, so the whole tree stays small
HW = 64


def _fill(tree, rng):
    """Seeded values for every leaf, scaled to keep activations O(1)."""

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = x.shape
        if name.endswith("['kernel']") or name.endswith("['weight']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['alpha']"):
            return np.asarray(rng.uniform(0.0, 0.3), np.float32).reshape(shape)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def shared():
    cfg = Configuration("train_synthetic_stereodpnet_plus", make_workspace=False)
    cfg.data["model"]["inplanes"] = C
    opt = cfg.get_config()
    model = jax_model_selector(opt)
    batch = jax.tree_util.tree_map(jnp.asarray, _tiny_batch(1, HW, HW))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, train=False))
    rng = np.random.default_rng(0)
    variables = _fill(shapes, rng)
    # non-zero offset heads, so the deform convs sample off the grid
    for i in (1, 2):
        off = variables["params"]["normal_estimator"][f"deform_conv{i}"]["conv_offset"]
        off["kernel"] = off["kernel"] * 4.0
        off["bias"] = rng.standard_normal(off["bias"].shape).astype(np.float32)
    pt_cfg = load_config("stereodpnet_plus", model_overrides={"inplanes": C})
    pt_model = build_model(pt_cfg, device="cpu")
    load_state_dict(pt_model, state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return opt, variables, pt_model


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"].get(name, {})}


def _cf(x):
    """channels-last numpy -> channels-first torch."""
    return torch.movedim(torch.from_numpy(np.ascontiguousarray(x)), -1, 1)


def _cl(t):
    """channels-first torch -> channels-last numpy."""
    return torch.movedim(t, 1, -1).numpy()


# ---------------------------------------------------------------- blocks

def _bn_state(var, prefix):
    p, s = var["params"]["BatchNorm_0"], var["batch_stats"]["BatchNorm_0"]
    return {f"{prefix}weight": p["scale"], f"{prefix}bias": p["bias"],
            f"{prefix}running_mean": s["mean"], f"{prefix}running_var": s["var"],
            f"{prefix}num_batches_tracked": np.asarray(0)}


def _f2t(w):
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def _init_flax(mod, *args):
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), *args))
    return _fill(shapes, np.random.default_rng(1))


def _load(tmod, sd):
    tmod.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, strict=True)
    return tmod.eval()


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 3), (2, 2)])
def test_convbn(stride, dilation):
    x = np.random.default_rng(2).standard_normal((2, 12, 10, 5)).astype(np.float32)
    jm = jax_blocks.ConvBN(7, 3, stride, dilation=dilation)
    var = _init_flax(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = _load(pt_blocks.ConvBN(5, 7, 3, stride, dilation=dilation),
               {"0.weight": _f2t(var["params"]["Conv_0"]["kernel"]), **_bn_state(var, "1.")})
    np.testing.assert_allclose(_cl(tm(_cf(x)).detach()), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_convbn3d(stride):
    x = np.random.default_rng(3).standard_normal((1, 4, 8, 6, 5)).astype(np.float32)
    jm = jax_blocks.ConvBN3D(6, 3, stride, 1)
    var = _init_flax(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = _load(pt_blocks.ConvBN3D(5, 6, 3, stride, 1),
               {"0.weight": _f2t(var["params"]["Conv_0"]["kernel"]), **_bn_state(var, "1.")})
    np.testing.assert_allclose(_cl(tm(_cf(x)).detach()), ref, rtol=1e-5, atol=1e-5)


def test_tconvbn3d():
    x = np.random.default_rng(4).standard_normal((1, 2, 4, 3, 6)).astype(np.float32)
    jm = jax_blocks.TConvBN3D(5)
    var = _init_flax(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = _load(pt_blocks.TConvBN3D(6, 5),
               {"0.weight": _f2t(var["params"]["ConvTranspose_0"]["kernel"]), **_bn_state(var, "1.")})
    out = _cl(tm(_cf(x)).detach())
    assert out.shape == (1, 4, 8, 6, 5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_depthwise_separable_conv():
    x = np.random.default_rng(5).standard_normal((2, 9, 7, 6)).astype(np.float32) * 2
    jm = jax_blocks.DepthwiseSeparableConv(8)
    var = _init_flax(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    p = var["params"]
    sd = {"depthwise.weight": _f2t(p["Conv_0"]["kernel"]), "pointwise.weight": _f2t(p["Conv_1"]["kernel"]),
          "prelu.weight": np.asarray(p["PReLU_0"]["alpha"]).reshape(1), **_bn_state(var, "bn.")}
    tm = _load(pt_blocks.DepthwiseSeparableConv(6, 8), sd)
    np.testing.assert_allclose(_cl(tm(_cf(x)).detach()), ref, rtol=1e-5, atol=1e-5)


def test_instance_norm_and_prelu():
    x = (np.random.default_rng(6).standard_normal((2, 5, 6, 4)) * 3 + 1).astype(np.float32)
    jm = jax_blocks.InstanceNorm()
    var = _init_flax(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    g = var["params"]["GroupNorm_0"]
    tm = _load(pt_blocks.InstanceNorm(4), {"weight": g["scale"], "bias": g["bias"]})
    np.testing.assert_allclose(_cl(tm(_cf(x)).detach()), ref, rtol=1e-5, atol=1e-5)

    # PReLU's field `init` shadows Module.init: apply it to a given alpha
    ref = jax_blocks.PReLU().apply({"params": {"alpha": jnp.float32(0.05)}}, jnp.asarray(x))
    got = pt_blocks.PReLU(0.05)(torch.from_numpy(x)).detach().numpy()
    assert (x < 0).any()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "name,shape,arg",
    [("upsample2d_bilinear", (2, 5, 7, 3), 4), ("downsample2d_nearest", (2, 16, 12, 3), 4),
     ("upsample3d_trilinear", (1, 3, 4, 5, 2), 4)],
)
def test_resizes(name, shape, arg):
    x = np.random.default_rng(14).standard_normal(shape).astype(np.float32)
    ref = np.asarray(getattr(jax_resize, name)(jnp.asarray(x), arg))
    got = getattr(pt_resize, name)(torch.from_numpy(x), arg).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_resize_nearest_to_any_size():
    x = np.random.default_rng(15).standard_normal((1, 5, 7, 2)).astype(np.float32)
    ref = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), (9, 4), (1, 2)))
    got = pt_resize.resize_nearest(torch.from_numpy(x), (9, 4), (1, 2)).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------- ASM

@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_subpixel_shift_planes(direction):
    x = np.random.default_rng(7).standard_normal((2, 12, 5, 3)).astype(np.float32)
    disps = [-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5]
    ref = jax_asm.subpixel_shift_planes(jnp.asarray(x), disps, direction, layout="list")
    got = pt_asm.subpixel_shift_planes(torch.from_numpy(x), disps, direction, axis=1)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        # nearest/bilinear are exact copies and lerps; the phase shift is an
        # f32 matmul against the same numpy operator
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_asm_cost_volume_fast_attention(shared):
    """The hoisted-head attention (joint (mode, h, w) InstanceNorm stats,
    softmax over modes, gated mean) inside the whole cost volume."""
    opt, variables, pt_model = shared
    rng = np.random.default_rng(8)
    ref_f, tar_f = (rng.standard_normal((2, 16, 12, C)).astype(np.float32) for _ in range(2))
    jm = JaxASMCostVolume(opt, opt.model.mindisp, opt.model.maxdisp)
    ref = np.asarray(jm.apply(_sub(variables, "cost_volume"), jnp.asarray(ref_f), jnp.asarray(tar_f), False))
    got = pt_model.cost_volume(_cf(ref_f), _cf(tar_f)).detach()
    np.testing.assert_allclose(_cl(got), ref, rtol=1e-5, atol=1e-5)


def test_feature_extraction(shared):
    opt, variables, pt_model = shared
    x = np.random.default_rng(9).standard_normal((2, HW, HW, 3)).astype(np.float32)
    jm = JaxFeatureExtraction(opt)
    ref = np.asarray(jm.apply(_sub(variables, "feature_extraction"), jnp.asarray(x), False))
    got = _cl(pt_model.feature_extraction(_cf(x)).detach())
    assert got.shape == (2, HW // 4, HW // 4, C)
    # ~20 conv layers in f32 with sums in another order
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("upsample", [False, True], ids=["coarse", "upsampled"])
def test_aggregation(shared, upsample):
    opt, variables, pt_model = shared
    cost = np.random.default_rng(10).standard_normal((1, 8, 8, 12, 2 * C)).astype(np.float32)
    jm = JaxAggregation(C, upsample=upsample, dfold="auto", dpack_mode="full")
    logits, feats = jm.apply(_sub(variables, "aggregation"), jnp.asarray(cost), False)
    pt_model.aggregation.upsample = upsample
    try:
        [got_logits], [got_feat] = pt_model.aggregation(_cf(cost))
    finally:
        pt_model.aggregation.upsample = False
    assert got_logits.shape == logits[0].shape
    # 22 3-D convs in f32 with sums in another order
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_cl(got_feat.detach()), np.asarray(feats[0]), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------- ANM

def test_sample_with_sort_ties_and_windows():
    cr = np.arange(8) * 0.5 - 1.0
    cost = np.random.default_rng(11).standard_normal((2, 8, 3, 5, 4)).astype(np.float32)
    # exact plane hits (ties), midpoints, and values past both ends
    disp = np.array([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 1.75, 2.5, -3.0, 9.0] * 3, np.float32).reshape(2, 3, 5)
    for k in (4, 3):  # k = 3 takes the top-k fallback
        rc, rd = jax_nm.sample_with_sort(jnp.asarray(cost), jnp.asarray(disp), cr, k)
        gc, gd = pt_nm.sample_with_sort(torch.from_numpy(cost), torch.from_numpy(disp), cr, k)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    # the fallback agrees with the fast window rule on the uniform grid
    fc, fd = pt_nm._sample_topk_fallback(torch.from_numpy(cost), torch.from_numpy(disp), cr.astype(np.float32), 4)
    rc, rd = jax_nm.sample_with_sort(jnp.asarray(cost), jnp.asarray(disp), cr, 4)
    np.testing.assert_array_equal(fd.numpy(), np.asarray(rd))


def test_grid_maker_3d():
    rng = np.random.default_rng(12)
    K = np.tile(np.array([[[740.0, 0, 48.0], [0, 740.0, 48.0], [0, 0, 1]]], np.float32), (2, 1, 1))
    disp = rng.uniform(-1, 2.5, (2, 4, 6, 5)).astype(np.float32)
    ab = np.array([[32.98, -26996.49], [30.0, -25000.0]], np.float32)
    ref = np.asarray(jax_nm.grid_maker_3d(jnp.asarray(K), jnp.asarray(disp), jnp.asarray(ab)))
    got = pt_nm.grid_maker_3d(*(torch.from_numpy(a) for a in (K, disp, ab))).numpy()
    # min-max normalised to [0, 1]; the 3x3 inverse is taken by two libraries
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_anm(shared):
    """The whole normal branch given the same cost and disparity, so the
    (discontinuous) sample_with_sort window sees identical inputs; the
    deform convs run windowed with non-zero offsets."""
    opt, variables, pt_model = shared
    rng = np.random.default_rng(13)
    cost = rng.standard_normal((1, 8, 16, 16, C)).astype(np.float32)
    disp = rng.uniform(-4, 12, (1, HW, HW)).astype(np.float32)
    batch = {k: v for k, v in _tiny_batch(1, HW, HW).items() if k in ("K", "abvalue")}
    jm = jax_nm.ANM(opt, opt.model.mindisp, opt.model.maxdisp)
    normals, off1s, _ = jm.apply(_sub(variables, "normal_estimator"), [jnp.asarray(cost)], [jnp.asarray(disp)],
                                {k: jnp.asarray(v) for k, v in batch.items()}, False)
    normal, got_off1, _ = pt_model.normal_estimator(
        _cf(cost), torch.from_numpy(disp), {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    # the offsets clamp binds somewhere, so the windowed semantics are live
    off1 = np.asarray(off1s[0])
    assert float(np.abs(off1).max()) > 3.0
    np.testing.assert_allclose(got_off1.detach().numpy(), off1, rtol=1e-4, atol=1e-4)
    # two deform convs and a 6-layer dilated stack in f32, then a sigmoid
    np.testing.assert_allclose(normal.detach().numpy(), np.asarray(normals[0]), rtol=1e-4, atol=1e-4)


def test_fused_regression_matches_unfused(shared):
    """`fused_regression` changes only which path regresses the same logits:
    the fused soft-argmin (no probability volume) or upsample + soft-argmin."""
    _, _, pt_model = shared
    batch = {k: torch.from_numpy(v) for k, v in _tiny_batch(1, HW, HW).items()}
    with torch.no_grad():
        fused = pt_model(batch)
        pt_model.fused, pt_model.aggregation.upsample = False, True
        try:
            unfused = pt_model(batch)
        finally:
            pt_model.fused, pt_model.aggregation.upsample = True, False
    assert fused["prob_depth"] is None
    assert tuple(unfused["prob_depth"].shape) == (1, 1, 32, HW, HW)
    # the same f32 interpolation and softmax, summed in another order
    np.testing.assert_allclose(fused["pred_depth"].numpy(), unfused["pred_depth"].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused["pred_normal"].numpy(), unfused["pred_normal"].numpy(), rtol=1e-5, atol=1e-5)
