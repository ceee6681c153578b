"""The port's face parser (`dualpixelface_tpu_torch/models/face_seg/`)
against the JAX package's, on the CPU.

Weights: JAX's BiSeNet variable tree, every leaf refilled from a seed
(`torch_zoo.fill`: activations O(1), running statistics away from (0, 1)),
carried to the port's reference names by
`weights.state_dict_from_jax(..., model="face_seg")` and loaded with
strict=True. Held: the three eval outputs at 64x64, the names through the
JAX package's own converter (`tools/convert_face_seg_weights.py`) back to
the tree they came from, and `FaceMaskEstimator` at size 64 from a saved
state_dict file.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo as zoo
from dualpixelface_tpu.models.face_seg.evaluate import FaceMaskEstimator as JaxFaceMaskEstimator
from dualpixelface_tpu.models.face_seg.model import BiSeNet as JaxBiSeNet
from dualpixelface_tpu_torch.models.face_seg import BiSeNet, FaceMaskEstimator
from dualpixelface_tpu_torch.weights import load_state_dict, state_dict_from_jax
from torch_cpu_setup import two_threads

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from convert_face_seg_weights import convert_face_seg_state_dict  # noqa: E402

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

HW = 64


@pytest.fixture(scope="module")
def seeded():
    """(JAX variables as numpy, the port's state_dict) from seed 0."""
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxBiSeNet(19).init(jax.random.PRNGKey(0), x, train=False))
    variables = zoo.fill(shapes, np.random.default_rng(0))
    return variables, state_dict_from_jax(variables["params"], variables["batch_stats"], model="face_seg")


def test_state_dict_names_are_the_references(seeded):
    """Every parameter and buffer of the port's BiSeNet, by the reference's
    names (`cp.resnet.*`, `cp.arm16.*`, `cp.conv_avg.*`, `ffm.*`,
    `conv_out{,16,32}.*`), filled by the bridge and loaded strictly."""
    _, sd = seeded
    model = BiSeNet(19)
    assert set(sd) == set(model.state_dict())
    for prefix in ("cp.resnet.layer4.0.downsample.1.running_var", "cp.arm16.bn_atten.weight",
                   "cp.conv_avg.conv.weight", "ffm.conv2.weight", "conv_out16.conv_out.weight"):
        assert prefix in sd, prefix
    load_state_dict(model, sd)


def test_converter_round_trip(seeded):
    """The JAX package's converter reads the port's state_dict back into
    the Flax tree it was made from, leaf for leaf."""
    variables, sd = seeded
    params, stats = convert_face_seg_state_dict(sd)
    want = jax.tree_util.tree_map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    got = {"params": params, "batch_stats": stats}
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_bisenet_eval_outputs_match_jax(seeded):
    """out, out16 and out32 at 64x64 (1/32: 2x2), batch 2, to 1e-4 of each
    head's largest logit (f32 through ~20 convs and BatchNorms, sums in
    another order)."""
    variables, sd = seeded
    x = np.random.default_rng(1).standard_normal((2, HW, HW, 3)).astype(np.float32)
    want = JaxBiSeNet(19).apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), train=False)
    model = load_state_dict(BiSeNet(19), sd).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == (2, 19, HW, HW)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_face_mask_estimator_matches_jax(seeded, tmp_path):
    """`FaceMaskEstimator(size=64)` on a 48x40 uint8 image (the /255 path),
    weights from a torch state_dict file loaded strictly, against JAX's
    estimator on the same tree: the main head's logits at 64x64 to 1e-4 of
    the largest, and the same mask, pixel for pixel; the mask neither empty
    nor full."""
    variables, sd = seeded
    path = tmp_path / "face_seg.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    image = (np.random.default_rng(2).uniform(size=(48, 40, 3)) * 255).astype(np.uint8)

    ref = JaxFaceMaskEstimator(size=HW)
    ref.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    est = FaceMaskEstimator(checkpoint=str(path), size=HW, device="cpu")
    want_mask = ref(image)
    got_mask = est(image)
    assert got_mask.shape == want_mask.shape == (48, 40) and got_mask.dtype == bool
    np.testing.assert_array_equal(got_mask, want_mask)
    assert 0 < got_mask.mean() < 1

    x = np.asarray(image, np.float32) / 255.0
    from dualpixelface_tpu.data.preprocess.augmentation import IMAGENET_MEAN, IMAGENET_STD
    from dualpixelface_tpu.ops.resize import resize_linear

    xj = resize_linear(jnp.asarray((x - IMAGENET_MEAN) / IMAGENET_STD)[None], (HW, HW), (1, 2), True)
    want_logits = np.asarray(JaxBiSeNet(19).apply(ref.variables, xj, train=False)[0])
    got_logits = est.logits(image).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=1e-4 * np.abs(want_logits).max())


def test_estimator_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceMaskEstimator(size=HW)
