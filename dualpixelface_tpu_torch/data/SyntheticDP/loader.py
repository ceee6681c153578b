"""In-memory synthetic dual-pixel dataset (counterpart of
`dualpixelface_tpu/data/SyntheticDP/loader.py`).

The FaceDP pipeline's schema twin (SURVEY.md §7.2 step 2): every later stage
(models, losses, metrics, train loop, benchmarks) runs against this without
the 481 GB benchmark on disk. Produces the same sample-dict surface as
FaceDPLoader, deterministically per (seed, index).
"""
from __future__ import annotations

import numpy as np

from dualpixelface_tpu_torch.data import preprocess
from dualpixelface_tpu_torch.data.loader_selector import register_loader
from dualpixelface_tpu_torch.data.SyntheticDP.synthesis import synth_sample


@register_loader("SyntheticDP")
class SyntheticDPLoader:
    def __init__(self, option, training: bool):
        self.opt = option
        self.training = training
        ds = option.dataset
        self.h = int(ds.height)
        self.w = int(ds.width)
        self.n = int(ds.train_samples if training else ds.test_samples)
        self.seed = int(getattr(ds, "seed", 1234))
        self.transform = preprocess.basic_transform(option)
        self.raw_transform = preprocess.raw_transform(option)

    def __len__(self):
        return self.n

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        rng = rng if rng is not None else np.random.default_rng()
        raw = synth_sample(index, self.h, self.w, camidx=1 + index % 8, seed=self.seed)

        inputs = [raw["left"], raw["right"], raw["center"]]
        targets = [raw["depth"], raw["mask"], raw["disp"], raw["idepth"], raw["normal"], None]

        p_inputs, p_targets = self.transform.apply(inputs, targets, rng)
        coords = self.transform.coords

        sample = {
            "left": p_inputs[0],
            "right": p_inputs[1],
            "center": p_inputs[2],
            "depth": p_targets[0],
            "mask": p_targets[1],
            "disp": p_targets[2],
            "idepth": p_targets[3],
            "normal": p_targets[4],
            "K": raw["K"].copy(),
            "P": raw["P"],
            "abvalue": raw["abvalue"],
            "metadata": raw["metadata"],
            "L": raw["L"],
            "coords": np.asarray(coords, np.float32),
            "pathname": f"synth_{index:05d}",
        }
        sample["K"][0, 2] -= coords[0]
        sample["K"][1, 2] -= coords[1]
        if not self.training:
            sample["groupname"] = "synthetic_group"
        return sample
