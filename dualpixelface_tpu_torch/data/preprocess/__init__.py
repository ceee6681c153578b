"""Preprocessing of the port's loaders (counterpart of `dualpixelface_tpu/data/preprocess/`)."""
from dualpixelface_tpu_torch.data.preprocess.preprocess import basic_transform, raw_transform

__all__ = ["basic_transform", "raw_transform"]
