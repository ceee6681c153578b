"""The PyTorch port's data path against the JAX package's, on the CPU.

SyntheticDP samples and FaceDP samples read from an on-disk RCV fixture
tree (with `use_raw`, with `use_multi`), through the host preprocessing's
numpy chain and, where `native/libdphost.so` builds, its native data plane,
must equal the JAX package's bit for bit for the same (seed, epoch, index)
draws; so must the fixture writer's files, the scan cache (each package
reads the other's), the DataLoader's batches (order, `_valid`, string
keys; two epochs, 0 and 2 workers) against the JAX `DataPipeline`, and the
test-time group swap. Inputs are made from seeds at 64x64.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dualpixelface_tpu.config import Configuration as JaxConfiguration
from dualpixelface_tpu.data.loader_selector import loader_selector as jax_loader_selector
from dualpixelface_tpu.data.pipeline import DataPipeline as JaxDataPipeline
from dualpixelface_tpu.data.preprocess import native as jax_native
from dualpixelface_tpu.data.SyntheticDP.fixture import write_fixture_tree as jax_write_fixture_tree
from dualpixelface_tpu.models.base import SWAP_GROUP as JAX_SWAP_GROUP
from dualpixelface_tpu.models.base import apply_group_swap as jax_apply_group_swap
from dualpixelface_tpu_torch.config import Configuration
from dualpixelface_tpu_torch.data.loader_selector import loader_selector
from dualpixelface_tpu_torch.data.pipeline import make_pipeline, numeric_batch
from dualpixelface_tpu_torch.data.preprocess import native
from dualpixelface_tpu_torch.data.SyntheticDP.fixture import write_fixture_tree
from dualpixelface_tpu_torch.models.base import SWAP_GROUP, apply_group_swap
from torch_cpu_setup import two_threads

two_threads()  # MKL's vector math warmed on one thread first (tests/torch_cpu_setup.py)

REPO = Path(__file__).resolve().parent.parent
HW = 64  # crops of 32 (config_train: ratio 0.75) or 64 (config_test, config_demo) at crop_factor 32


def _options(name, overrides=None, dataset=None):
    """The JAX package's and the port's merged run config `name`, with the
    same overrides, dataset keys and crop factor 32."""
    out = []
    for cls in (JaxConfiguration, Configuration):
        cfg = cls(name, make_workspace=False, overrides=overrides)
        cfg.data["dataset"].update(dataset or {})
        cfg.data["crop_aug"]["soft_crop"]["crop_factor"] = 32
        out.append(cfg.get_config())
    return out


def _assert_samples_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, str):
            assert g == r, k
            continue
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype, r.dtype, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=k)


def _both_samples(jopt, popt, training, indices, native_on):
    jds, pds = jax_loader_selector(jopt, training), loader_selector(popt, training)
    jds.transform.use_native = pds.transform.use_native = native_on
    for epoch in (0, 1):
        for i in indices:
            ref = jds.__getitem__(i, rng=np.random.default_rng((1, epoch, i)))
            got = pds.__getitem__(i, rng=np.random.default_rng((1, epoch, i)))
            yield got, ref


@pytest.fixture(scope="module")
def native_lib():
    """`native/libdphost.so` loaded by both packages: built (to a temporary
    name, then renamed into place) when absent; the native cases skip
    where no C++ toolchain builds it."""
    so = REPO / "native" / "libdphost.so"
    if not so.exists():
        tmp = so.with_name(f".libdphost.{os.getpid()}.so")
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-Wall", "-o", str(tmp),
                            str(REPO / "native" / "dphost.cpp")], check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            tmp.unlink(missing_ok=True)
            return f"native/libdphost.so does not build here: {e}"
    if not (native.available() and jax_native.available()):
        return "native/libdphost.so does not load"
    return None


def _native_case(native_on, native_lib):
    if native_on and native_lib is not None:
        pytest.skip(native_lib)


@pytest.mark.parametrize("native_on", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("aug", ["config_train", "config_test", "config_demo"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_synthetic_samples_match_jax(training, aug, native_on, native_lib):
    """Every field of SyntheticDP samples 0-2, epochs 0 and 1, bit for bit:
    the random crop and lighting (config_train), the centre crop
    (config_test) and brightness, gamma and contrast (config_demo)."""
    _native_case(native_on, native_lib)
    jopt, popt = _options("train_synthetic_stereodpnet_plus", {"augmentation_config": aug},
                          {"height": HW, "width": HW, "train_samples": 3, "test_samples": 3})
    for got, ref in _both_samples(jopt, popt, training, range(3), native_on):
        _assert_samples_equal(got, ref)


def test_synthetic_path_imports_no_image_library():
    """The SyntheticDP loader, the pipeline and the trainer import neither
    PIL nor the FaceDP reader (the card machine has no Pillow)."""
    code = ("import sys\n"
            "from dualpixelface_tpu_torch.config import Configuration\n"
            "from dualpixelface_tpu_torch.data.loader_selector import loader_selector\n"
            "import dualpixelface_tpu_torch.train.trainer, dualpixelface_tpu_torch.main\n"
            "opt = Configuration('train_synthetic_stereodpnet_plus', make_workspace=False).get_config()\n"
            "loader_selector(opt, True)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'PIL' or 'FaceDP' in m or 'visualizer' in m\n"
            "             or m.endswith('fixture'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.fixture(scope="module")
def fixture_trees(tmp_path_factory):
    """RCV fixture trees written by the JAX package's writer: one view per
    sample (4 train, 2 test), and cameras 1-3 for every view (multi-view)."""
    single = jax_write_fixture_tree(tmp_path_factory.mktemp("rcv_single"), n_train=4, n_test=2, height=HW, width=HW)
    multi = jax_write_fixture_tree(tmp_path_factory.mktemp("rcv_multi"), n_train=2, n_test=1, height=HW, width=HW,
                                   cams=(1, 2, 3))
    return {"single": single, "multi": multi}


def _facedp_options(root, use_raw, use_multi):
    overrides = {"use_raw": use_raw, "use_multi": use_multi}
    if use_multi:
        overrides["select_view"] = [1, 2, 3]
    return _options("train_faceDP", overrides, {"path": str(root)})


@pytest.mark.parametrize("native_on", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("use_raw,use_multi", [(False, False), (True, False), (True, True)],
                         ids=["plain", "raw", "raw-multi"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_facedp_samples_match_jax(fixture_trees, training, use_raw, use_multi, native_on, native_lib):
    """FaceDP samples read from the JAX writer's fixture tree, every field
    bit for bit (the raw_* copies and the multi-view stacks included), and
    the same scanned records."""
    _native_case(native_on, native_lib)
    root = fixture_trees["multi" if use_multi else "single"]
    jopt, popt = _facedp_options(root, use_raw, use_multi)
    jds, pds = jax_loader_selector(jopt, training), loader_selector(popt, training)
    assert list(pds.pathdata) == list(jds.pathdata) and len(pds) == len(jds) > 0
    for got, ref in _both_samples(jopt, popt, training, range(len(jds)), native_on):
        _assert_samples_equal(got, ref)
        if use_raw:
            assert "raw_left" in got
        if use_multi:
            assert got["lefts"].shape[0] == 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scan_cache_is_read_both_ways(tmp_path, writer):
    """The scan cache one package writes (FaceDP_<split>_single.npy in the
    dataset root) is the file the other reads: a package that finds it
    does not rescan, and both list the same records."""
    root = jax_write_fixture_tree(tmp_path / "rcv", n_train=2, n_test=1, height=HW, width=HW)
    jopt, popt = _facedp_options(root, False, False)
    first, second = (loader_selector, jax_loader_selector) if writer == "port" else (jax_loader_selector, loader_selector)
    opts = (popt, jopt) if writer == "port" else (jopt, popt)
    records = first(opts[0], True).pathdata
    cache = root / "FaceDP_train_single.npy"
    assert cache.is_file()
    # a record the reader can only know from the cache
    written = np.load(cache, allow_pickle=True)
    written[0] = list(written[0]) + [dict(written[0][0], parentdir="from-the-cache")]
    np.save(cache, written)
    got = second(opts[1], True).pathdata
    assert list(got) == list(records) + [dict(records[0], parentdir="from-the-cache")]


def test_fixture_writer_matches_jax(tmp_path):
    """The port's writer gives the JAX writer's tree, file for file and
    byte for byte (JPEGs of the same arrays, depth and normal arrays,
    JSON records), single- and multi-view."""
    for kwargs in ({"n_train": 3, "n_test": 2}, {"n_train": 1, "n_test": 1, "cams": (1, 2)}):
        ours = write_fixture_tree(tmp_path / "ours", height=48, width=40, **kwargs)
        theirs = jax_write_fixture_tree(tmp_path / "theirs", height=48, width=40, **kwargs)
        files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
        assert len(files) > 10
        for rel in files:
            assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel
        shutil.rmtree(tmp_path / "ours")
        shutil.rmtree(tmp_path / "theirs")


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_dataloader_matches_jax_pipeline(training, workers):
    """Two epochs of batches from the port's DataLoader against the JAX
    DataPipeline: train shuffled per (seed, epoch) with the last partial
    batch dropped (7 samples, batch 2: 3 batches), test in order with the
    last batch padded (5 samples: the third batch has 1 real row); the
    numeric fields as CPU tensors, `_valid`, and the string keys as lists.

    The JAX pipeline runs on one thread here: its threads share one
    transform object, whose crop origin (`coords`, and with it the
    crop-adjusted `K`) another thread's sample can overwrite between a
    sample's crop and its read, so with 2 threads its batches vary from
    run to run. The port's workers are processes, each with its own copy,
    so any count gives the one-thread batches."""
    jopt, popt = _options("train_synthetic_stereodpnet_plus", {"batch_size": 2, "workers": workers},
                          {"height": HW, "width": HW, "train_samples": 7, "test_samples": 5})
    jpipe = JaxDataPipeline(jax_loader_selector(jopt, training), batch_size=2, shuffle=training, seed=1,
                            num_workers=1, drop_last=training)
    pipe = make_pipeline(popt, loader_selector(popt, training), training, seed=1)
    assert len(pipe) == len(jpipe) == 3
    orders = []
    for epoch in (0, 1):
        jpipe.set_epoch(epoch)
        pipe.set_epoch(epoch)
        ref, got = list(jpipe), list(pipe)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            for key in ("pathname", "groupname"):
                if key in r:
                    assert isinstance(g[key], list) and g[key] == r[key], key
            assert all(torch.is_tensor(v) and v.device.type == "cpu" for v in numeric_batch(g).values())
            assert set(numeric_batch(g)) == set(numeric_batch(r))
            _assert_samples_equal(g, r)
        orders.append([name for b in got for name in b["pathname"]])
        if not training:
            assert [b["_valid"].tolist() for b in got] == [[True, True], [True, True], [True, False]]
            assert got[-1]["pathname"] == ["synth_00004", "synth_00004"]
    # shuffled per epoch in training, in order for the test
    assert (orders[0] != orders[1]) == training


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("group", [SWAP_GROUP, "group_test"])
def test_apply_group_swap_matches_jax(group, training):
    assert SWAP_GROUP == JAX_SWAP_GROUP
    rng = np.random.default_rng(5)
    left, right = rng.standard_normal((2, 4, 4, 3)), rng.standard_normal((2, 4, 4, 3))
    batch = {"left": left, "right": right, "groupname": [group, group]}
    got = apply_group_swap(dict(batch), training)
    ref = jax_apply_group_swap(dict(batch), training)
    assert got["left"] is ref["left"] and got["right"] is ref["right"]
    assert (got["left"] is right) == (group == SWAP_GROUP and not training)
