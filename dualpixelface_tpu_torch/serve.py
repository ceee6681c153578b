"""Serving entry point of the port: the counterpart of
`__graft_entry__.entry` and of the serving forward `bench.py` measures.

    predictor = Predictor(load_config("stereodpnet_plus"))   # CUDA, bf16
    results = predictor(batch)   # batch: left/right [B, H, W, 3], K, abvalue

Weights and floating inputs are cast to the serving dtype, as the JAX
serving path casts its variables and batch. The forward runs in eval mode
under `torch.inference_mode()`. On the card, the stages the model
declares in `graph_stages` replay from CUDA graphs (`utils/graphs`; the
first call of a shape runs eagerly, the second captures); a model that
declares none, and every CPU predictor, runs eagerly. Tracer spans
(`utils/profiling`): `serve.call` around a call, `serve.h2d` around the
request's cast and copy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dualpixelface_tpu_torch import resolve_device
from dualpixelface_tpu_torch.models import build_model
from dualpixelface_tpu_torch.ops.precision import exact_f32
from dualpixelface_tpu_torch.utils.graphs import StageGraphs
from dualpixelface_tpu_torch.utils.profiling import span, to_device
from dualpixelface_tpu_torch.weights import load_state_dict


class Predictor:
    def __init__(self, config, state_dict=None, device="cuda", dtype=torch.bfloat16):
        """`state_dict`: reference-named weights (numpy or tensors, e.g.
        from `weights.state_dict_from_jax`); None keeps the seeded init.
        A float32 predictor turns TF32 off for the process
        (`ops.precision.exact_f32`)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        if dtype == torch.float32:
            exact_f32()
        model = build_model(config, device="cpu")
        if state_dict is not None:
            load_state_dict(model, state_dict)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        stages = getattr(model, "graph_stages", ())
        self.graphs = StageGraphs(self.model, stages) if stages and self.device.type == "cuda" else None

    def _cast(self, v):
        t = to_device(v, self.device)
        return t.to(self.dtype) if t.is_floating_point() else t

    def __call__(self, batch: dict) -> dict:
        with span("serve.call"), torch.inference_mode():
            with span("serve.h2d"):
                inputs = {k: self._cast(v) for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
            return self.model(inputs)


def bench_batch(b: int, h: int, w: int, seed: int = 0) -> dict:
    """A request batch of the JAX package's bench recipe (`bench.py`): random
    left/right views, a fixed affine dual-pixel model, a pinhole K at
    f = 7400 px centred in the image."""
    rng = np.random.default_rng(seed)
    return {
        "left": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "right": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "K": np.tile(np.array([[[7400.0, 0, w / 2], [0, 7400.0, h / 2], [0, 0, 1]]], np.float32), (b, 1, 1)),
        "abvalue": np.tile(np.array([[32.98, -26996.49]], np.float32), (b, 1)),
    }


def seeded_state_dict(config, seed: int = 0) -> dict:
    """Seeded weights with the deform offset heads made non-zero (at init
    they are zero and the deform convs would sample only the grid)."""
    model = build_model(config, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name in ("deform_conv1", "deform_conv2"):
            conv = getattr(model.normal_estimator, name).conv_offset
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 2.0 / math.sqrt(fan_in))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    return model.state_dict()
