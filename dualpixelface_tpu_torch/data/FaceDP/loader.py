"""FaceDP dataset (counterpart of `dualpixelface_tpu/data/FaceDP/loader.py`;
ref dataloader/FaceDP/loader.py:80-200).

Per-item: read JSON -> load L/R/LR JPG + depth/normal/albedo NPY + calibration
-> transform -> dict of channels-last numpy arrays with the reference's key
surface: left, right, center, depth, mask, disp, idepth, normal, albedo,
K, P, abvalue, metadata, L, coords (+ raw_* copies when use_raw, + multi-view
lists when use_multi, + groupname/pathname).

The scanned path list is cached to <dataset>_{train,test}_{single,multi}.npy
next to the dataset root (ref loader.py:93-110; the cache is kept beside the
data rather than the CWD). It is a pickled object array of plain dicts and
strings, the same file the JAX package reads and writes.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from dualpixelface_tpu_torch.data import preprocess
from dualpixelface_tpu_torch.data.FaceDP.path_reader import RCVDPReader
from dualpixelface_tpu_torch.data.loader_selector import register_loader
from dualpixelface_tpu_torch.utils.file_manager import error_handler

INPUT_NAMES = ["left", "right", "center"]
TARGET_NAMES = ["depth", "mask", "disp", "idepth", "normal", "albedo"]
PARAM_NAMES = ["K", "P", "abvalue", "metadata", "L", "coords"]


@register_loader("FaceDP")
class FaceDPLoader:
    def __init__(self, option, training: bool):
        self.opt = option
        self.training = training
        self.parentdir = option.dataset.path
        self.use_multi = bool(getattr(option, "use_multi", False))
        error_handler(os.path.isdir(self.parentdir), f"{self.parentdir} does not exist", __name__, True)

        tag = "train" if training else "test"
        kind = "multi" if self.use_multi else "single"
        cache = Path(self.parentdir) / f"{option.dataset_name}_{tag}_{kind}.npy"

        self.pathreader = RCVDPReader(option, self.parentdir, training)
        if not cache.is_file():
            self.pathdata, self.datalen = self.pathreader.read_rcv_path()
            try:
                np.save(cache, np.array([self.pathdata, self.datalen], dtype=object))
            except OSError:
                pass  # read-only dataset roots are fine; just rescan next time
        else:
            self.pathdata, self.datalen = np.load(cache, allow_pickle=True)

        self.transform = preprocess.basic_transform(option)
        self.raw_transform = preprocess.raw_transform(option)

    def __len__(self):
        return len(self.pathdata)

    @staticmethod
    def _add(sample: dict, tensors, names):
        for t, name in zip(tensors, names):
            if isinstance(t, list):
                if t and t[0] is not None:
                    sample[name] = np.stack([np.asarray(x) for x in t], 0)
            elif t is not None:
                sample[name] = np.asarray(t)
        return sample

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        rng = rng if rng is not None else np.random.default_rng()
        sample: dict = {}
        record = self.pathdata[index]
        parent = Path(record["parentdir"])

        with open(record["tar_view"]) as f:
            json_data = json.load(f)
        inputs, targets, params = self.pathreader.load_data_depth(json_data, parent)

        p_inputs, p_targets = self.transform.apply(inputs, targets, rng)
        params = list(params) + [np.asarray(self.transform.coords, np.float32)]

        sample = self._add(sample, p_inputs, INPUT_NAMES)
        sample = self._add(sample, p_targets, TARGET_NAMES)
        sample = self._add(sample, params, PARAM_NAMES)

        # crop-adjusted principal point (ref loader.py:154-155)
        sample["K"] = sample["K"].copy()
        sample["K"][0, 2] -= self.transform.coords[0]
        sample["K"][1, 2] -= self.transform.coords[1]

        if getattr(self.opt, "use_raw", False):
            r_inputs, r_targets = self.raw_transform.apply(inputs, targets, rng)
            sample = self._add(sample, r_inputs, [f"raw_{n}" for n in INPUT_NAMES])
            sample = self._add(sample, r_targets, [f"raw_{n}" for n in TARGET_NAMES])

        if self.use_multi:
            error_handler(record["ref_view"] is not None, "multi-view dataloader error", __name__, True)
            multi_inputs, multi_targets, multi_params = [], [], []
            for sub in record["ref_view"]:
                with open(sub) as f:
                    sub_json = json.load(f)
                i_, t_, pa_ = self.pathreader.load_data_depth(sub_json, parent, True)
                i_, t_ = self.raw_transform.apply(i_, t_, rng)
                multi_inputs.append(i_)
                multi_targets.append(t_)
                multi_params.append(pa_)
            tr = lambda lists: [list(x) for x in zip(*lists)]
            sample = self._add(sample, tr(multi_inputs), ["lefts", "rights", "centers"])
            sample = self._add(
                sample, tr(multi_targets), ["depths", "masks", "disps", "idepths", "normals", "albedos"]
            )
            sample = self._add(sample, tr(multi_params), ["Ks", "Ps", "abvalues", "metadatas", "Ls"])

        if not self.training:
            sample["groupname"] = Path(record["tar_view"]).parts[-3]
        sample["pathname"] = Path(record["tar_view"]).stem
        return sample
