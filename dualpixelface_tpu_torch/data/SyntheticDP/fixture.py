"""On-disk FaceDP fixture writer (counterpart of
`dualpixelface_tpu/data/SyntheticDP/fixture.py`).

Materializes a miniature RCV-layout dataset tree (train.txt/test.txt, group
dirs with JSON/ IMG/ DEPTH/ NORMAL/ subdirs) from the synthetic generator so
FaceDPLoader + RCVDPReader are exercised against real file IO without the
481 GB benchmark (ref dataloader/FaceDP/loader.py:16-77 schema doc).

Note the dataset's on-disk left/right JPGs are swapped — the reference
compensates by unpacking `right, left, lr = read_img(...)`
(path_reader.py:280). The fixture writes synth-left into PATH['right'] (and
vice versa) so a loaded batch's 'left' equals the synthesized left view.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from dualpixelface_tpu_torch.data.SyntheticDP.synthesis import synth_sample


def write_fixture_tree(
    root: str | Path,
    n_train: int = 4,
    n_test: int = 2,
    height: int = 96,
    width: int = 96,
    seed: int = 7,
    cams=None,
) -> Path:
    """cams=None writes one camera per view index (single-view layout);
    cams=(1,2,3) writes every camera for every view index so the multi-view
    ref_view lookup (INFO_<cam>_<view>_<light>.json) resolves."""
    root = Path(root)
    specs = [("train", "group_train", n_train), ("test", "group_test", n_test)]

    for split, group, count in specs:
        gdir = root / group
        for sub in ("JSON", "IMG/LEFT", "IMG/RIGHT", "IMG/LRSUM", "DEPTH", "NORMAL"):
            (gdir / sub).mkdir(parents=True, exist_ok=True)
        (root / f"{split}.txt").write_text(group + "\n")

        entries = []
        for i in range(count):
            if cams is None:
                entries.append((i, 1 + i % 8))
            else:
                entries.extend((i, c) for c in cams)

        for i, cam in entries:
            s = synth_sample(
                (i * 16 + cam) if split == "train" else (1000 + i * 16 + cam),
                height, width, camidx=cam, seed=seed,
            )
            viewidx, lightidx = i, 1
            tag = f"{cam}_{viewidx}_{lightidx}"

            # swapped on disk (see module docstring)
            Image.fromarray(s["right"]).save(gdir / f"IMG/LEFT/IMG_{tag}.JPG", quality=95)
            Image.fromarray(s["left"]).save(gdir / f"IMG/RIGHT/IMG_{tag}.JPG", quality=95)
            Image.fromarray(s["center"]).save(gdir / f"IMG/LRSUM/IMG_{tag}.JPG", quality=95)
            np.save(gdir / f"DEPTH/DEPTH_{cam}_{viewidx}.npy", s["depth"].astype(np.float64))
            np.save(gdir / f"NORMAL/NORMAL_{cam}_{viewidx}.npy", s["normal"])

            K = s["K"]
            intrinsic = [
                float(K[0, 0]), float(K[1, 1]), float(K[0, 1]),
                float(K[0, 2]), float(K[1, 2]), 0.0, 0.0, 0.0, 0.0,
            ]
            pose = [float(v) for v in np.eye(3, 4).reshape(-1)]
            info = {
                "INFO": {
                    "valid": True,
                    "object": group,
                    "gender": "w" if i % 2 == 0 else "m",
                    "camidx": cam,
                    "lightidx": lightidx,
                    "expression": "neutral",
                    "position": "forward",
                    "direction": "front",
                },
                "PATH": {
                    "root": ".",
                    "left": f"IMG/LEFT/IMG_{tag}.JPG",
                    "right": f"IMG/RIGHT/IMG_{tag}.JPG",
                    "lrsum": f"IMG/LRSUM/IMG_{tag}.JPG",
                    "depth": f"DEPTH/DEPTH_{cam}_{viewidx}.npy",
                    "normal": f"NORMAL/NORMAL_{cam}_{viewidx}.npy",
                },
                "PARAMS": {
                    "intrinsic": "array(" + json.dumps(intrinsic) + ")",
                    "pose": "array(" + json.dumps(pose) + ")",
                    "Lvalue": None,
                    "abvalue": None,
                },
            }
            with open(gdir / f"JSON/INFO_{tag}.json", "w") as f:
                json.dump(info, f)

    return root


# The multi-view training run (the overrides of tests/test_multiview.py on
# `train_faceDP_dpnet`): dpnet's `config_multi`, the reference views' raw
# centre images, smoothL1 + the folded loss.
MULTIVIEW_RUN = {"model_config": "config_multi", "use_multi": True, "use_raw": True, "select_view": [1, 2, 3]}
MULTIVIEW_LOSSES = {"loss_type": ["smoothL1", "folded"], "lambdas": [1.0, 0.1]}


def write_multiview_run(root: str | Path, fixture: str | Path, name: str = "train_faceDP_dpnet_multi",
                        overrides: dict | None = None) -> Path:
    """Write the multi-view training run over the FaceDP tree `fixture`
    under `root`: `configs/<name>.json` (the committed `train_faceDP_dpnet`
    with MULTIVIEW_RUN, `multi_view.use_center_img` and `overrides`), and
    beside it the model config (`config_multi` with MULTIVIEW_LOSSES) and
    the dataset config (FaceDP's, its path the fixture), which the run
    config names by absolute path. A run config sets no model key, so the
    losses come in through a model config of their own. Returns the run
    config's path (for `--config`)."""
    from dualpixelface_tpu_torch.config.manager import PACKAGE_ROOT as package, REPO_ROOT as repo

    root = Path(root)
    model = json.loads((package / "models" / "dpnet" / "config_multi.json").read_text())
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "dpnet_multi.json").write_text(json.dumps({**model, **MULTIVIEW_LOSSES}))
    data = json.loads((package / "data" / "FaceDP" / "config.json").read_text())
    (root / "facedp.json").write_text(json.dumps({**data, "path": str(fixture)}))
    run = json.loads((repo / "configs" / "train_faceDP_dpnet.json").read_text())
    run.update(MULTIVIEW_RUN, model_config=str(root / "dpnet_multi"), dataset_config=str(root / "facedp"),
               multi_view={**run["multi_view"], "use_center_img": True}, **(overrides or {}))
    path = root / "configs" / f"{name}.json"
    path.write_text(json.dumps(run))
    return path
