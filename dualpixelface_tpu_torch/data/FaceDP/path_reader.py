"""RCV facial dual-pixel benchmark reader (host side, pure numpy/PIL; a copy
of `dualpixelface_tpu/data/FaceDP/path_reader.py`).

Parity target: reference `dataloader/FaceDP/path_reader.py:16-352`. Reads the
on-disk RCV layout (train.txt/test.txt -> group dirs -> JSON/ metadata ->
JPG images + NPY depth/normal/albedo), filters samples by the dataset config
(valid/light/gender/camidx/expression/position/direction), converts metric
depth to defocus disparity through the affine model disp = a/depth + b using
either the per-camera pre-calibrated abvalue table or the thin-lens metadata
formula with k = 0.13372, and assembles the (inputs, targets, params) triple
with per-flag None-ing.

Deviation: calibration strings are parsed with `json`-safe literal parsing
instead of the reference's `eval()` (path_reader.py:240-249).
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
from PIL import Image

from dualpixelface_tpu_torch.data.calibration import ABVALUE_LIST, DEFAULT_METADATA, THIN_LENS_K
from dualpixelface_tpu_torch.utils.file_manager import error_handler


def intrinsic2KD(intrinsic) -> tuple[np.ndarray, np.ndarray]:
    """9-vector -> (K [3,3], D [4]) (a copy of `dualpixelface_tpu/ops/geometry.py`
    intrinsic2KD; ref geometry.py:144-166). Host-side numpy."""
    intrinsic = np.asarray(intrinsic, dtype=np.float64)
    K = np.zeros((3, 3))
    K[0, 0] = intrinsic[0]
    K[0, 1] = intrinsic[2]
    K[0, 2] = intrinsic[3]
    K[1, 1] = intrinsic[1]
    K[1, 2] = intrinsic[4]
    K[2, 2] = 1.0
    D = np.array(intrinsic[5:9])
    return K, D


def _parse_array_string(strvalue: str):
    """Parse the dataset's 'array([...])'-style stringified arrays safely."""
    inner = strvalue[6:-1] if strvalue.startswith("array(") else strvalue
    return ast.literal_eval(inner)


def _rgb_to_gray(x: np.ndarray) -> np.ndarray:
    # cv2 BGR2GRAY on an RGB-ordered npy (ref read_normal uses cv2 on the raw
    # array): weights applied to channels [0.114, 0.587, 0.299] in BGR order.
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


class RCVDPReader:
    def __init__(self, option, parentdir, training: bool):
        self.option = option
        self.training = training
        self.parentdir = Path(parentdir)
        self.abvalue_list = ABVALUE_LIST

    # ---------- path scanning ----------

    def read_directory(self) -> list[Path]:
        filepath = self.parentdir / ("train.txt" if self.training else "test.txt")
        error_handler(filepath.is_file(), f"{filepath} does not exist", __name__, True)
        out = []
        for line in filepath.read_text().splitlines():
            line = line.strip()
            if line:
                out.append(self.parentdir / line)
        return out

    def read_rcv_path(self):
        """Walk group dirs, filter JSON samples per dataset options
        (ref path_reader.py:54-124). Returns (records, count)."""
        jsonpaths = []
        opt = self.option.dataset
        use_multi = bool(getattr(self.option, "use_multi", False))

        for path in self.read_directory():
            json_dir = path / "JSON"
            for jsonpath in sorted(json_dir.glob("*.json")):
                with open(jsonpath) as f:
                    info = json.load(f)["INFO"]
                if not bool(info["valid"]):
                    continue
                if info["lightidx"] not in opt.light:
                    continue
                if info["gender"] not in opt.gender:
                    continue
                if info["camidx"] not in opt.viewpoint:
                    continue
                if info["expression"] not in opt.expression:
                    continue
                if info["position"] not in opt.distance:
                    continue
                if info["direction"] not in opt.direction:
                    continue

                record = {"tar_view": str(jsonpath), "parentdir": str(path), "ref_view": None}
                if use_multi:
                    viewidx = int(jsonpath.stem.split("_")[-2])
                    lightidx = int(info["lightidx"])
                    subpaths = []
                    for cam in self.option.select_view:
                        sub = json_dir / f"INFO_{cam}_{viewidx}_{lightidx}.json"
                        if not sub.is_file():
                            continue
                        with open(sub) as f:
                            if not bool(json.load(f)["INFO"]["valid"]):
                                continue
                        subpaths.append(str(sub))
                    if not subpaths:
                        continue
                    while len(subpaths) < len(self.option.select_view):
                        subpaths.append(subpaths[-1])
                    record["ref_view"] = subpaths
                jsonpaths.append(record)
        return jsonpaths, len(jsonpaths)

    # ---------- per-sample IO ----------

    def read_img(self, json_data, rootdir: Path):
        paths = json_data["PATH"]
        left = np.asarray(Image.open(rootdir / paths["left"]))
        right = np.asarray(Image.open(rootdir / paths["right"]))
        lr = np.asarray(Image.open(rootdir / paths["lrsum"]))
        return left, right, lr

    def read_depth(self, json_data, rootdir: Path):
        depth = np.load(rootdir / json_data["PATH"]["depth"]).astype(np.float64)
        if "mask" in json_data["PATH"]:
            mask = np.load(rootdir / json_data["PATH"]["mask"]) > 0
        else:
            mask = depth > 0
        max_depth = np.max(depth[mask])
        idepth = np.divide(max_depth, depth, where=mask, out=np.zeros_like(depth))
        depth = np.where(mask, depth, 0.0)
        return depth, idepth, mask

    def read_normal(self, json_data, rootdir: Path):
        normal = np.load(rootdir / json_data["PATH"]["normal"]).astype(np.float32)
        mask = _rgb_to_gray(normal) > 0
        return normal, mask

    def read_albedo(self, json_data, rootdir: Path):
        albedo = np.load(rootdir / json_data["PATH"]["albedo"]).astype(np.float32)
        return albedo, albedo > 0

    def read_disparity(self, json_data, parentdir: Path, abvalue=None, metadata=None, fy=None):
        """Depth -> defocus disparity (ref path_reader.py:193-234). Returns
        (disparity, depth, idepth, mask, abvalue[b, a])."""
        depth, idepth, mask = self.read_depth(json_data, parentdir)

        if abvalue is not None:
            a, b = abvalue[0], abvalue[1]
            abvalue = [abvalue[1], abvalue[0]]  # -> [b, a] storage order
        elif metadata is not None:
            f, g, fnum, _pixsize = metadata
            a = -THIN_LENS_K * (fy / fnum) * f / (1 - f / g)
            b = THIN_LENS_K * (fy / fnum) * f / (1 - f / g) * (1 / g)
            abvalue = [b, a]
        else:
            raise NotImplementedError("no way to convert depth to disparity")

        disparity = np.divide(a, depth, where=mask, out=np.zeros_like(depth)) + np.where(mask, b, 0.0)

        # invalid-region fill x50 (ref path_reader.py:227-229)
        fill = np.max(disparity[mask]) * 50.0
        disparity = np.where(mask, disparity, fill)
        disparity = np.where(np.isfinite(disparity), disparity, fill)
        error_handler(bool(np.isfinite(disparity).all()), "nan/inf in disparity", __name__, True)
        return disparity, depth, idepth, mask, abvalue

    def read_calib(self, json_data):
        params = json_data["PARAMS"]
        intrinsic = _parse_array_string(params["intrinsic"])
        extrinsic = _parse_array_string(params["pose"])
        L = _parse_array_string(params["Lvalue"]) if params.get("Lvalue") is not None else None
        abvalue = self.abvalue_list[json_data["INFO"]["camidx"]]
        metadata = list(DEFAULT_METADATA)
        return intrinsic, extrinsic, L, abvalue, metadata

    def load_data_depth(self, json_data, parentdir: Path, multi: bool = False):
        """Assemble (inputs, targets, params) with per-flag None-ing
        (ref path_reader.py:263-352)."""
        intrinsic, extrinsic, L, abvalue, metadata = self.read_calib(json_data)

        # extrinsic 12-vector -> [4, 4] P (ref path_reader.py:275-276)
        ext = np.asarray(extrinsic, np.float64).reshape(-1)
        P = np.reshape(
            np.transpose(np.concatenate([ext[:, None], np.zeros((3, 1)), np.ones((1, 1))], 0)),
            (4, 4),
        )
        K, _ = intrinsic2KD(intrinsic)

        # the dataset's left/right JPGs are swapped on disk (ref :280 comment)
        right, left, lr = self.read_img(json_data, parentdir)

        flags = self.option.multi_view if multi else self.option
        normal = albedo = None
        if flags.use_normal:
            normal, _ = self.read_normal(json_data, parentdir)
            normal = np.ascontiguousarray(normal, np.float32)
        if flags.use_albedo:
            albedo, _ = self.read_albedo(json_data, parentdir)
            albedo = np.ascontiguousarray(albedo, np.float32)

        dispmap, depthmap, idepthmap, mask, abvalue = self.read_disparity(
            json_data, parentdir, abvalue=abvalue, metadata=metadata, fy=K[1][1]
        )
        mask = np.ascontiguousarray(mask, np.float32)
        dispmap = np.ascontiguousarray(dispmap, np.float32)
        depthmap = np.ascontiguousarray(depthmap, np.float32)
        idepthmap = np.ascontiguousarray(idepthmap, np.float32)

        if not flags.use_dual_pixel:
            left = right = None
        if not flags.use_center_img:
            lr = None
        if not flags.use_mask:
            mask = None
        if not flags.use_disparity:
            dispmap = None
        if not flags.use_depth:
            depthmap = None
        if not flags.use_idepth:
            idepthmap = None

        if L is None:
            L = np.zeros((3, 3))

        inputs = [left, right, lr]
        targets = [depthmap, mask, dispmap, idepthmap, normal, albedo]
        params = [
            np.float32(K),
            np.float32(P),
            np.float32(abvalue),
            np.float32(metadata),
            np.float32(L),
        ]
        return inputs, targets, params
