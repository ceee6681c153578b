"""Convert a reference DualPixelFace StereoDPNet checkpoint to a checkpoint
of this package (counterpart of `tools/convert_stereodpnet_checkpoint.py`).

    python -m dualpixelface_tpu_torch.tools.convert_stereodpnet_checkpoint ref.ckpt out.pt \\
        --config eval_synthetic_stereodpnet [--device cuda|cpu]
    python -m dualpixelface_tpu_torch.main --config eval_synthetic_stereodpnet --workspace w --load_model out.pt

The port's StereoDPNet carries the reference module tree's state_dict
names (`weights.py`), so the conversion is no renaming: it takes the
reference's keys that the JAX converter consumes, in the JAX exporter's
order, and leaves out the reference's buffers the port has no place for
(`cost_volume.costrange`, `normal_estimator.grid`, `regression_layer.*`),
as the JAX converter's leftover pattern does. The BatchNorms'
`num_batches_tracked` load into the port's own counters (absent ones
start at 0). The ASM's InstanceNorm, registered twice in the reference
(`normalize` and `mask_convs.3.1`), must hold the same values under both
names. The ASM PReLU of `asm_activation: "relu"` has no reference name:
the JAX converter's tree has no leaf for it, so a JAX model restoring that
tree keeps its init, and the port's converter writes that init, 0.05.

Unlike the JAX tool, which warns, the CLI raises on any reference key the
port has no place for (the port's loads are strict), builds the run
config's model and optimizer (`train/state.create_train_state`), loads the
weights with `strict=True`, and writes a checkpoint as
`train/checkpoint.save_checkpoint` does (the weights, a fresh optimizer,
step 0, epoch 0), which `--load_model` restores under `load_strict: true`.
"""
from __future__ import annotations

import argparse
import re
from typing import Callable, Iterator

import torch

# the reference's buffers the JAX converter drops without a word
DROPPED = re.compile(r"num_batches_tracked$|costrange$|\bgrid$|regression_layer")
ASM_PRELU = "cost_volume.attention_layer.prelu.weight"
ASM_PRELU_INIT = 0.05
FE, AT, AG, NE = "feature_extraction", "cost_volume.attention_layer", "aggregation", "normal_estimator"


def _bn(t: str) -> list[str]:
    return [f"{t}.weight", f"{t}.bias", f"{t}.running_mean", f"{t}.running_var", f"{t}.num_batches_tracked"]


def _convbn(t: str) -> list[str]:
    return [f"{t}.0.weight"] + _bn(f"{t}.1")


def _dpblock(t: str) -> list[str]:
    keys = _convbn(f"{t}.conv1.0") + [f"{t}.conv1.1.weight"] + _convbn(f"{t}.conv2.0") + [f"{t}.conv2.1.weight"]
    for i in range(3):
        keys += _convbn(f"{t}.conv_dilate.{i}")
    keys += _convbn(f"{t}.conv3") + [f"{t}.prelu.weight"] + _convbn(f"{t}.conv4.0") + [f"{t}.conv4.1.weight"]
    keys += [f"{t}.conv5.depthwise.weight", f"{t}.conv5.pointwise.weight"] + _bn(f"{t}.conv5.bn")
    return keys + [f"{t}.conv5.prelu.weight", f"{t}.conv_skip.weight", f"{t}.conv_skip.bias"]


def reference_keys(has: Callable[[str], bool], block_stack: int = 1) -> Iterator[str]:
    """The reference STEREODPNET state_dict keys that the JAX converter
    consumes and the JAX exporter writes, in the exporter's order. `has(key)`
    says whether the tree holds a key; it picks the ANM's branches, as both
    JAX tools do: the deform convs (`use_deform`), the ConvBN3D pair of
    `use_deform=false` (`original_conv`), and the ANM itself (absent with
    `predict_normal` false)."""
    for idx in (0, 2, 4):
        yield from _convbn(f"{FE}.firstconv.{idx}")
    yield from _dpblock(f"{FE}.block1")
    for i in range(block_stack):
        yield from _dpblock(f"{FE}.interblock1.{i}")
    yield from _dpblock(f"{FE}.block2")
    for i in range(block_stack):
        yield from _dpblock(f"{FE}.interblock2.{i}")
    yield from _dpblock(f"{FE}.block3")
    for i in range(3):
        for part in (f"inner_blocks.{i}", f"layer_blocks.{i}"):
            yield from (f"{FE}.fpn.{part}.weight", f"{FE}.fpn.{part}.bias")
    yield from _convbn(f"{FE}.lastconv.0")
    yield from _convbn(f"{FE}.lastconv.2")

    yield f"{AT}.mask_convs.0.weight"
    yield from _bn(f"{AT}.mask_convs.1")
    yield f"{AT}.mask_convs.3.0.weight"
    for name in (f"{AT}.normalize", f"{AT}.mask_convs.3.1"):
        yield from (f"{name}.weight", f"{name}.bias")

    for name in ("dres0.0", "dres0.2", "dres1.0", "dres1.2"):
        yield from _convbn(f"{AG}.{name}")
    for i in (2, 3, 4):
        for name in ("conv1.0", "conv3.0", "conv4.0", "conv2", "conv5", "conv6"):
            yield from _convbn(f"{AG}.dres{i}.{name}")
    for i in (1, 2, 3):
        yield from _convbn(f"{AG}.classif{i}.0")
        yield f"{AG}.classif{i}.2.weight"

    if not has(f"{NE}.n_convs.0.0.weight"):
        return
    if has(f"{NE}.deform_conv1.weight"):
        for i in (1, 2):
            t = f"{NE}.deform_conv{i}"
            yield from (f"{t}.weight", f"{t}.bias", f"{t}.conv_offset.weight", f"{t}.conv_offset.bias")
            yield from _bn(f"{NE}.act{i}.0")
    if has(f"{NE}.original_conv.0.0.weight"):
        yield from _convbn(f"{NE}.original_conv.0")
        yield from _convbn(f"{NE}.original_conv.2")
    for i in range(6):
        yield f"{NE}.n_convs.{i}.0.weight"


def convert_stereodpnet_state_dict(sd: dict, block_stack: int = 1, asm_activation: str = "sigmoid"):
    """Reference STEREODPNET state_dict -> (the port's state_dict, leftover).

    The state_dict holds CPU tensors under the port's (the reference's)
    names, the values the JAX converter would put into its tree;
    `num_batches_tracked` the reference's counts where it has them, else 0.
    `leftover` lists every key that the JAX converter would leave
    unconsumed and does not drop by its pattern. Raises
    KeyError on a missing key, ValueError when the two names of the ASM's
    InstanceNorm hold different values."""
    if asm_activation not in ("sigmoid", "relu"):
        raise NotImplementedError(f"asm activation {asm_activation!r}")
    for part in ("weight", "bias"):
        a, b = f"{AT}.normalize.{part}", f"{AT}.mask_convs.3.1.{part}"
        if b in sd and not torch.equal(torch.as_tensor(sd[a]), torch.as_tensor(sd[b])):
            raise ValueError(f"{a} and {b} are one module in the reference and must hold the same values")
    out = {}
    for key in reference_keys(sd.__contains__, block_stack):
        if key.endswith("num_batches_tracked"):
            out[key] = torch.as_tensor(sd.get(key, 0), dtype=torch.int64).reshape(())
            continue
        if key.startswith(f"{AT}.mask_convs.3.1."):
            key_from = key.replace("mask_convs.3.1", "normalize")
        else:
            key_from = key
        out[key] = torch.as_tensor(sd[key_from]).detach().cpu().clone()
        if key == f"{AT}.mask_convs.3.1.bias" and asm_activation == "relu":
            out[ASM_PRELU] = torch.full((1,), ASM_PRELU_INIT)
    leftover = sorted(k for k in sd if k not in out and not DROPPED.search(k))
    return out, leftover


def load_reference_state_dict(path) -> dict:
    """The state_dict of a reference checkpoint file: the payload's
    `state_dict`, else its `model`, else the payload itself (as the JAX
    tool reads it)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{path} holds a {type(payload).__name__}, not a state_dict")
    return payload.get("state_dict", payload.get("model", payload))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="reference StereoDPNet checkpoint -> a checkpoint of this package")
    ap.add_argument("reference_ckpt", help="the reference's checkpoint (torch.save of a state_dict, bare or under "
                                           "'state_dict' or 'model')")
    ap.add_argument("out", help="the checkpoint to write (.pt)")
    ap.add_argument("--config", required=True, help="run config (name under configs/, or a path) whose model and "
                                                    "optimizer the checkpoint is for")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model is built and loaded (default: the card)")
    args = ap.parse_args(argv)

    from dualpixelface_tpu_torch.config import Configuration
    from dualpixelface_tpu_torch.train.checkpoint import checkpoint_payload
    from dualpixelface_tpu_torch.train.state import create_train_state

    opt = Configuration(args.config, make_workspace=False).get_config()
    if opt.model_name not in ("stereodpnet", "stereodpnet_plus"):
        raise ValueError(f"run config {args.config} is of model {opt.model_name!r}; the reference checkpoints "
                         "converted here are StereoDPNet's")
    sd = load_reference_state_dict(args.reference_ckpt)
    state_dict, leftover = convert_stereodpnet_state_dict(sd, int(opt.model.block_stack), opt.model.asm_activation)
    if leftover:
        raise ValueError(f"{len(leftover)} keys of {args.reference_ckpt} have no place in the port's "
                         f"{opt.model_name}: {leftover[:20]}")
    state = create_train_state(opt, steps_per_epoch=1, state_dict=state_dict, device=args.device)
    torch.save(checkpoint_payload(state, epoch=0), args.out)
    print(f"converted {len(state_dict)} tensors of {args.reference_ckpt} into {args.out} ({opt.model_name}, "
          f"{sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)


if __name__ == "__main__":
    main()
