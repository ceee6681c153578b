"""The port's `bts` against the JAX package's, on the CPU.

The nearest upsampling and the local planar guidance; the silog loss on a
mask that zeroes part of the depth; each of the six backbones of
`RESNET_SPECS` and `DENSENET_SPECS` at 64x64; a torchvision-named
state_dict through the JAX package's converter (`tools/convert_bts_encoder.py`);
the eval forward at 64x64, batch 2, at bts_size 256 (`reduc1x1`'s sigmoid
head) and 64 (its 4-channel plane stack); one f32 train step at bts_size 64
(losses, gradients, batch statistics, updated parameters) from weights
carried across by `weights.state_dict_from_jax`; `Trainer.fit` and `test`
on SyntheticDP with a restore. Shared pieces and the tolerances' reasons:
`tests/torch_zoo.py`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu.losses.silog import SilogLoss as JaxSilogLoss
from dualpixelface_tpu.models.bts import encoder as jax_encoder
from dualpixelface_tpu.models.bts.mainmodel import local_planar_guidance as jax_lpg
from dualpixelface_tpu.ops.resize import upsample2d_nearest as jax_upsample2d_nearest
from dualpixelface_tpu_torch.losses.silog import SilogLoss
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.models.bts.encoder import DENSENET_SPECS, RESNET_SPECS, make_encoder
from dualpixelface_tpu_torch.models.bts.mainmodel import local_planar_guidance
from dualpixelface_tpu_torch.ops.resize import upsample2d_nearest
from dualpixelface_tpu_torch.weights import bts_encoder_state_dict, load_state_dict
from tools.convert_bts_encoder import convert_densenet_state_dict, convert_resnet_state_dict
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

MODEL = "bts"
SMALL = {"bts_size": 64}  # the JAX package's own test width (tests/test_model_zoo.py)
# of views seeds 1-8, the first where JAX and the port in f32 take every
# kink alike (at 1-4 and 6 a few gradients in layer2-4 or the ASPP differ
# by 3e-3 to 7e-2: a ReLU of the 2x2 layer4 taken the other way moves its
# BatchNorm's statistics); 7 and 8 are clean too
VIEWS_SEED = 5


def plane_stack_in_depth_units(variables, option):
    """At bts_size 64 `reduc1x1` runs no conv and hands `conv1` its plane
    stack, whose distance channel is sigmoid x max_depth, in millimetres:
    with `torch_zoo.fill`'s weights it drives the final sigmoid to exactly
    1 (every depth 1500, every gradient 0). Its rows of `conv1`'s kernel
    are divided by max_depth here."""
    conv1 = variables["params"]["decoder"]["conv1"]
    kernel = np.array(conv1["kernel"])
    kernel[:, :, kernel.shape[2] - 4, :] /= float(option.model.max_depth)  # before the three depths
    conv1["kernel"] = kernel
    return variables


def quiet_residuals(variables, option):
    """`plane_stack_in_depth_units`, and each bottleneck's last BatchNorm
    scale times 0.1 (torchvision's zero_init_residual, not quite zero). With
    `fill`'s U(0.5, 1.5) the 16 residual branches and their ReLUs are
    chaotic: in f64 a 1e-7 relative change of every weight moves the
    gradients by 1.6e-4 (the median over the parameters), and the two
    packages' f32 gradients differ by 9e-3 (the median); with these scales
    the f64 change is 1.4e-6."""
    variables = plane_stack_in_depth_units(variables, option)
    for name, node in variables["params"]["encoder"].items():
        if name.startswith("layer"):
            node["bn3"]["scale"] = np.asarray(node["bn3"]["scale"]) * 0.1
    return variables


# ------------------------------------------------------------------ the ops

@pytest.mark.parametrize("factor", [2, 3])
def test_upsample2d_nearest_matches_jax(factor):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_upsample2d_nearest(jnp.asarray(x), factor))
    got = upsample2d_nearest(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(got.numpy(), want)
    cf = upsample2d_nearest(torch.from_numpy(x).movedim(-1, 1), factor, axes=(2, 3))
    np.testing.assert_array_equal(cf.movedim(1, -1).numpy(), want)


@pytest.mark.parametrize("upratio", [2, 4, 8])
def test_local_planar_guidance_matches_jax(upratio):
    """Unit normals within 60 degrees of the view axis (n3 >= 0.5, as the
    heads make them) and distances in [700, 1500]: to rtol 1e-6."""
    rng = np.random.default_rng(upratio)
    theta = rng.uniform(0, math.pi / 3, (2, 3, 5))
    phi = rng.uniform(0, 2 * math.pi, (2, 3, 5))
    pe = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta),
                   rng.uniform(700, 1500, (2, 3, 5))], axis=-1).astype(np.float32)
    want = np.asarray(jax_lpg(jnp.asarray(pe), upratio))
    got = local_planar_guidance(torch.from_numpy(pe).movedim(-1, 1), upratio).numpy()
    assert got.shape == want.shape == (2, 3 * upratio, 5 * upratio)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_silog_matches_jax():
    """BTS's loss (target_type depth) on a mask that zeroes the depth of a
    third of the pixels: the loss to 1e-6 relative and its gradient with
    respect to pred_depth to 1e-5 of its largest entry; zero gradient off
    the mask; and the same without a mask."""
    jopt, popt = zoo.options(MODEL, {})
    rng = np.random.default_rng(3)
    pred = rng.uniform(700, 1500, (2, 1, 16, 16)).astype(np.float32)
    depth = rng.uniform(800, 1200, (2, 16, 16)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 16)) > 1 / 3).astype(np.float32)
    base = {"depth": depth * mask, "idepth": (1000 / depth).astype(np.float32),
            "abvalue": np.tile(np.float32([[32.98, -26996.49]]), (2, 1))}
    for batch in ({**base, "mask": mask}, {**base, "depth": depth}):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrad = jax.value_and_grad(
            lambda p: JaxSilogLoss(jopt)({"pred_depth": p}, jb, target_type="depth")["loss"])(jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_()
        loss = SilogLoss(popt)({"pred_depth": p}, {k: torch.from_numpy(v) for k, v in batch.items()},
                               target_type="depth")["loss"]
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=0, atol=1e-5 * np.abs(jgrad).max())
        if "mask" in batch:
            assert not p.grad.numpy()[:, 0][mask == 0].any()


# ------------------------------------------------------------------ the encoders

def encoder_pair(name: str, hw: int = 64, seed: int = 2):
    """The JAX encoder `name` with `torch_zoo.fill`'s weights and the port's
    with them carried across (`weights.bts_encoder_state_dict`), and a
    batch of one [1, hw, hw, 3]."""
    x = np.random.default_rng(seed).standard_normal((1, hw, hw, 3)).astype(np.float32)
    jm = jax_encoder.ResNetEncoder(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    variables = zoo.fill(shapes, np.random.default_rng(seed))
    port = make_encoder(name).eval()
    load_state_dict(port, bts_encoder_state_dict(variables["params"], variables["batch_stats"]))
    return jm, variables, port, x


def check_skips(want, got, channels) -> None:
    """Six skips at 1, 1/2, ..., 1/32 of the width, each within 1e-4 of its
    largest entry (f32 through up to 100 layers whose eval BatchNorms keep
    no scale)."""
    assert len(got) == len(want) == 6
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.movedim(1, -1).detach().numpy()
        assert g.shape == w.shape and g.shape[-1] == channels[i], (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=f"skip {i}")


@pytest.mark.parametrize("name", sorted(RESNET_SPECS) + sorted(DENSENET_SPECS))
def test_encoder_matches_jax(name):
    jm, variables, port, x = encoder_pair(name)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax.tree_util.tree_map(jnp.asarray, variables),
                                                           jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1))
    check_skips(want, got, port.channels)


def seeded_torchvision_state_dict(module, seed: int) -> dict:
    """`module`'s own names with values from a seed that keep the
    activations O(1): conv weights N(0, 1) / sqrt(fan in), BatchNorm
    scales and variances U(0.5, 1.5), biases and means 0.1 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            out[name] = t
        elif t.ndim > 1:
            out[name] = torch.randn(t.shape, generator=gen) / math.sqrt(t[0].numel())
        elif name.endswith(("running_var", "weight")):
            out[name] = 0.5 + torch.rand(t.shape, generator=gen)
        else:
            out[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return out


@pytest.mark.parametrize("name", ["resnext50_bts", "densenet121_bts"])
def test_torchvision_names_are_the_converters(name):
    """A state_dict in the port encoder's own names (torchvision's) loads
    into it with strict=True; the JAX package's converter reads every entry
    of it (but the counters) into the JAX encoder's tree, and both encoders
    give the same skips."""
    port = make_encoder(name).eval()
    sd = seeded_torchvision_state_dict(port, seed=4)
    port.load_state_dict(sd, strict=True)
    if name in DENSENET_SPECS:
        params, stats = convert_densenet_state_dict(sd, DENSENET_SPECS[name]["blocks"])
    else:
        params, stats = convert_resnet_state_dict(sd, RESNET_SPECS[name]["blocks"])
    read = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(stats))
    assert read == sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    want = jax.jit(lambda v, x: jax_encoder.ResNetEncoder(name).apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1))
    check_skips(want, got, port.channels)


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("over", [{}, SMALL], ids=["bts_size256", "bts_size64"])
def test_eval_matches_jax(over):
    """At bts_size 256 `reduc1x1` ends in its sigmoid head (conv1 takes
    16 + 1 + 3 channels); at 64 it runs no conv and returns the plane stack
    (4 + 4 + 3 = 11). The depth spans more than the floor: 0.37 mm the
    largest difference measured on depths of 700-1100 mm (rtol 1e-4)."""
    _, popt = zoo.options(MODEL, over)
    decoder = build_model(popt, device="cpu").decoder
    assert decoder.conv1.in_channels == (20 if not over else 11)
    assert len(decoder.reduc1x1.convs) == (2 if not over else 0)
    ref, got = zoo.eval_pair(MODEL, over, adjust=plane_stack_in_depth_units if over else None)
    zoo.check_eval(ref, got, {"pred_depth": (2, 1, 64, 64), "ref_feature": (2, 32, 32)})
    depth = got["pred_depth"].numpy()
    assert depth.min() >= 700 and depth.max() <= 1500 and depth.std() > 10


@pytest.fixture(scope="module")
def steps():
    jstep = zoo.jax_step(MODEL, SMALL, VIEWS_SEED, adjust=quiet_residuals)
    return jstep, zoo.port_step(MODEL, *jstep[:3])


def test_train_step_losses_match_jax(steps):
    """silog on the depth, to 1e-5 relative."""
    (_, _, _, ref, _), (_, got) = steps
    assert set(got) == set(ref) == {"silog_loss", "final_loss"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key


def test_train_step_gradients_match_jax(steps):
    """Per parameter within 1e-3 of its norm."""
    jstep, pstep = steps
    errs = zoo.gradient_errors(MODEL, jstep, pstep)
    assert len(errs) == len(list(pstep[0].model.parameters()))
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    assert not bad, bad


def test_train_step_batch_stats_and_update_match_jax(steps):
    """Every BatchNorm's statistics, the decoder's at momentum 0.01, and
    every parameter's update (`torch_zoo.update_errors`)."""
    jstep, pstep = steps
    # ResNet-50: bn1, 16 bottlenecks x 3, 4 downsamples; the decoder: bn5,
    # bn4, bn4_2, bn3, bn2, daspp_3's mid_bn, daspp_6-24's two
    assert zoo.check_batch_stats(MODEL, jstep, pstep) == 2 * (53 + 14)
    errs = zoo.update_errors(MODEL, jstep, pstep)
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    assert not bad, bad


def test_trainer_fits_tests_and_restores_on_the_cpu(tmp_path):
    zoo.check_fit(*zoo.fit_and_restore(tmp_path, MODEL, SMALL), ("absolute_dp", "affine_dp"))
