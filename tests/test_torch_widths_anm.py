"""The normal module (ANM) of `stereodpnet_plus` alone at `inplanes` 12,
`level` 20 in train mode against JAX's, on the CPU: forward, gradients
and running statistics. The rest of the widths' checks are
tests/test_torch_widths.py's; this one has a file of its own so that
pytest-xdist's `--dist loadfile` runs it on a worker of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_zoo as zoo
from __graft_entry__ import _tiny_batch
from dualpixelface_tpu.models.stereodpnet import normal_module as jax_nm
from dualpixelface_tpu_torch.config import load_config
from dualpixelface_tpu_torch.models.stereodpnet.normal_module import ANM
from dualpixelface_tpu_torch.weights import _Mapper, load_state_dict
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

OVER = {"inplanes": 12, "level": 20}
ZERO_GRAD = ("normal_estimator.deform_conv1.bias", "normal_estimator.deform_conv2.bias")


def test_normal_module_at_inplanes_12_level_20_trains_as_jax():
    """The ANM alone in train mode (batch statistics) at `inplanes` 12 and
    `level` 20, on a fixed cost volume and disparity map (so both packages
    sample the same 4 of the 20 planes): its deform convs 15 -> 24 and
    24 -> 24 with offset heads seeded past the +-3 window, windowed
    ('pallas', D = 4). The normals, the offsets and, for a seeded
    cotangent of the normals, the gradients of the cost volume and of every
    parameter within 1e-4 of each one's largest entry (f32 through two
    deform convs, two BatchNorms and a 6-layer dilated stack, sums in
    another order), the two deform biases, whose exact gradient is zero
    (each feeds a batch-statistics BatchNorm), within 1e-6 of their weight's
    gradient norm; the BatchNorms' running statistics within 1e-4."""
    hw = 64
    over = dict(OVER, deform_impl="pallas")
    c = over["inplanes"]
    cfg = zoo.JaxConfiguration("train_synthetic_stereodpnet_plus", make_workspace=False)
    cfg.data["model"].update(over)
    opt = cfg.get_config()
    rng = np.random.default_rng(41)
    cost = rng.standard_normal((1, over["level"], hw // 4, hw // 4, c)).astype(np.float32)
    disp = rng.uniform(-4, 12, (1, hw, hw)).astype(np.float32)
    batch = {k: v for k, v in _tiny_batch(1, hw, hw).items() if k in ("K", "abvalue")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_nm.ANM(opt, opt.model.mindisp, opt.model.maxdisp)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(cost)], [jnp.asarray(disp)], jbatch,
                                            False))
    variables = zoo.fill(shapes, rng)
    for i in (1, 2):  # offsets of a few voxels; larger ones leave most samples outside the
        # volume, the deform outputs near-constant and the train-mode BatchNorms ill-conditioned
        variables["params"][f"deform_conv{i}"]["conv_offset"]["kernel"] *= 1.5
    cot = rng.standard_normal((1, hw, hw, 3)).astype(np.float32)

    def loss(params, cost_):
        (normals, offs1, offs2), mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                               [cost_], [jnp.asarray(disp)], jbatch, True, mutable=["batch_stats"])
        return jnp.sum(normals[0] * cot), (normals[0], offs1[0], offs2[0], mut["batch_stats"])

    (_, (normal, off1, off2, stats)), (gparams, gcost) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(cost))

    def port_sd(params, batch_stats):
        m = _Mapper({"anm": params}, {"anm": batch_stats})
        m.anm("anm", "anm")
        return {k.removeprefix("anm."): v for k, v in m.sd.items()}

    pt = ANM(load_config("stereodpnet_plus", model_overrides=over), opt.model.mindisp, opt.model.maxdisp)
    load_state_dict(pt, port_sd(variables["params"], variables["batch_stats"])).train()
    assert tuple(pt.deform_conv1.weight.shape[:2]) == (24, 15) and tuple(pt.deform_conv2.weight.shape[:2]) == (24, 24)
    tcost = torch.movedim(torch.from_numpy(cost), -1, 1).requires_grad_(True)
    got, got1, got2 = pt(tcost, torch.from_numpy(disp), {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward(torch.from_numpy(cot))
    assert float(np.abs(np.asarray(off1)).max()) > 3.0
    for name, a, r in (("normal", got, normal), ("offset1", got1, off1), ("offset2", got2, off2),
                       ("cost", torch.movedim(tcost.grad, 1, -1), gcost)):
        r = np.asarray(r)
        np.testing.assert_allclose(a.detach().numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)
    ref = port_sd(jax.tree_util.tree_map(np.asarray, gparams), variables["batch_stats"])
    for name, p in pt.named_parameters():
        if "normal_estimator." + name in ZERO_GRAD:  # both packages' rounding: held to the weight's norm
            scale = float(np.linalg.norm(ref[name.replace(".bias", ".weight")]))
            assert max(np.linalg.norm(p.grad.numpy()), np.linalg.norm(ref[name])) <= 1e-6 * scale, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0, atol=1e-4 * np.abs(ref[name]).max(),
                                   err_msg=name)
    ref_stats = port_sd(variables["params"], jax.tree_util.tree_map(np.asarray, stats))
    for name, buf in pt.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref_stats[name], rtol=1e-4, atol=1e-6, err_msg=name)
