"""The rank functions of `tests/test_torch_parallel.py`. Each runs in a rank
that `parallel.spawn` started (gloo, on the CPU), begins with
`torch_cpu_setup.two_threads`, imports no JAX and returns numpy arrays and
plain values."""
from pathlib import Path

import numpy as np
import torch

from dualpixelface_tpu_torch import parallel
from dualpixelface_tpu_torch.config import Configuration, load_config
from dualpixelface_tpu_torch.losses import loss_selector
from dualpixelface_tpu_torch.losses.folded import FoldedLoss
from dualpixelface_tpu_torch.losses.silog import SilogLoss
from dualpixelface_tpu_torch.ops.blocks import BatchNorm2d, BatchNorm3d
from dualpixelface_tpu_torch.ops.precision import resolve_policy
from dualpixelface_tpu_torch.train.state import create_train_state
from dualpixelface_tpu_torch.train.steps import make_train_step
from dualpixelface_tpu_torch.train.trainer import Trainer
from dualpixelface_tpu_torch.weights import read_flax_msgpack, state_dict_from_jax
from torch_cpu_setup import two_threads

REPO = Path(__file__).resolve().parent.parent
PLATEAU = REPO / "tests" / "data" / "serving_plateau_192.msgpack"
NAME = "train_synthetic_stereodpnet_plus"


def plateau_state_dict() -> dict:
    variables = read_flax_msgpack(PLATEAU)
    return state_dict_from_jax(variables["params"], variables["batch_stats"])


def local_rows(batch: dict) -> dict:
    """This rank's rows of a global batch, as the pipeline cuts them."""
    w = parallel.world()
    n = next(iter(batch.values())).shape[0] // w.size
    return {k: v[w.rank * n:(w.rank + 1) * n] for k, v in batch.items()}


def batchnorm_rank(x: np.ndarray, weights: np.ndarray, calls: int) -> dict:
    """A seeded BatchNorm (2-D or 3-D by x's rank) in train mode on this
    rank's rows, `calls` times; the loss sum(y * weights) of the last call,
    its backward and the gradient all-reduce."""
    two_threads()
    torch.manual_seed(0)
    bn = (BatchNorm2d if x.ndim == 4 else BatchNorm3d)(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xr = torch.tensor(local_rows({"x": x})["x"], requires_grad=True)
    for _ in range(calls):
        y = bn(xr)
    (y * torch.tensor(local_rows({"w": weights})["w"])).sum().backward()
    parallel.all_reduce_grads(bn.parameters(), parallel.world())
    return {"y": y.detach().numpy(), "x_grad": xr.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy(), "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy()}


def silog_rank(batch: dict) -> dict:
    """BTS's silog (target_type depth) of `batch["pred"]` on this rank's
    rows, and its backward: the loss and the rows' gradient."""
    two_threads()
    rows = local_rows(batch)
    pred = torch.tensor(rows.pop("pred"), requires_grad=True)
    loss = SilogLoss(load_config("bts"))({"pred_depth": pred}, {k: torch.tensor(v) for k, v in rows.items()},
                                         target_type="depth")["loss"]
    loss.backward()
    return {"loss": float(loss.detach()), "grad": pred.grad.numpy()}


def folded_rank(batch: dict) -> dict:
    """dpnet's `config_multi` folded loss of `batch["pred"]` on this rank's
    rows, and its backward: the loss and the rows' gradient."""
    two_threads()
    cfg = Configuration("train_faceDP_dpnet", make_workspace=False, overrides={"model_config": "config_multi"})
    rows = local_rows(batch)
    pred = torch.tensor(rows.pop("pred"), requires_grad=True)
    loss = FoldedLoss(cfg.get_config())({"pred_depth": pred}, {k: torch.tensor(v) for k, v in rows.items()})["loss"]
    loss.backward()
    return {"loss": float(loss.detach()), "grad": pred.grad.numpy()}


def train_step_rank(batch: dict, precision=32) -> dict:
    """One stereodpnet_plus train step (Adam, the default run keys; f32
    unless `precision` is 'bf16') from the plateau weights on this rank's
    rows of `batch`: the losses it reports, the gradients after the
    all-reduce, the state after the update and its digest."""
    two_threads()
    cfg = load_config(run_overrides={"precision": precision})
    state = create_train_state(cfg, 100, state_dict=plateau_state_dict(), device="cpu")
    state, losses = make_train_step(state.model, loss_selector(cfg), resolve_policy(cfg))(state, local_rows(batch))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.numpy() for n, p in state.model.named_parameters()},
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "digest": parallel.state_digest(state.model)}


def configure(root, workspace, dataset, overrides=None, load_model=None):
    """tests/test_torch_trainer.py's run config: SyntheticDP at `dataset`'s
    size, 32x32 crops, global batch 2, no DataLoader workers."""
    cfg = Configuration(NAME, workspace=workspace, root=root, load_model=load_model,
                        overrides={"epoch": 1, "batch_size": 2, "workers": 0, **(overrides or {})})
    cfg.data["dataset"].update(dataset)
    cfg.data["crop_aug"]["soft_crop"]["crop_factor"] = 32
    return cfg.get_config()


def trainer_rank(root, workspace, fit_data, test_data) -> dict:
    """`Trainer.fit` (one epoch) then `test()` from the plateau weights;
    a second trainer with auto_resume and 2 epochs; then `test()` of a
    test-mode trainer restoring the epoch-0 checkpoint."""
    two_threads()
    opt = configure(root, workspace, fit_data)
    trainer = Trainer(opt, device="cpu", state_dict=plateau_state_dict())
    trainer.fit()
    fit_agg = trainer.test()
    resumed = Trainer(configure(root, workspace, fit_data, {"epoch": 2, "auto_resume": True}), device="cpu")
    resumed.fit()
    ckpt = str(Path(opt.ckpt_path) / "checkpoint_00.pt")
    over = {"mode": "test", "augmentation_config": "config_test"}
    test_agg = Trainer(configure(root, workspace, test_data, over, load_model=ckpt), device="cpu").test()
    return {"fit_agg": fit_agg, "test_agg": test_agg, "steps": [trainer.state.step, resumed.state.step],
            "digest": parallel.state_digest(resumed.state.model)}
