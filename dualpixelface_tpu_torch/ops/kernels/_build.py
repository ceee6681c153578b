"""Build and load the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each `csrc/<name>.cu` is compiled on its own for `sm_90a` into
`BUILD_DIR/lib<name>-<hash>.so`, where the hash covers the source and every
header it includes with quotes (`sources`), so an edited source or header
rebuilds and an unchanged one loads from the last build. BUILD_DIR is `build/torch_kernels/` of the checkout when the
package runs from one (a `pyproject.toml` beside the package), and
`~/.cache/dualpixelface_tpu_torch/torch_kernels/` for an installed copy.
`build()` starts one nvcc per missing library, all at once, and waits for
them; `load()` builds what it needs on first use. Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = (
    _PACKAGE.parent / "build" / "torch_kernels"
    if (_PACKAGE.parent / "pyproject.toml").is_file()
    else Path.home() / ".cache" / "dualpixelface_tpu_torch" / "torch_kernels"
)
KERNELS = ("conv3d_dslice", "deform_conv3d", "deform_conv3d_bwd", "fused_softargmin", "fused_softargmin_bwd",
           "conv3d_dslice_v2", "prims_gather", "prims_transpose", "prims_dot")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and every file it includes with `#include "..."`,
    directly or through another such include."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in found:
            found.append(f)
            todo += [f.parent / inc for inc in _INCLUDE.findall(f.read_text())]
    return found


def library_path(name: str) -> Path:
    """The library of kernel `name`, named by a hash of its sources."""
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every missing library in parallel. Returns, per kernel, the
    seconds its nvcc took (0.0 when it was already built) and the compiler's
    register/shared-memory report (that of the last build for a library
    already built). Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        (out.with_suffix(".log")).write_text(log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(rc: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of kernel library `name` (built first if
    missing), with its argument types set; it returns a cudaError code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_device(name: str, device) -> None:
    """A wrapper runs on the CPU (the plain version) or CUDA (the kernel)."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")


def check_cuda_tensors(name: str, device, **tensors) -> None:
    """CUDA is available, and every named tensor (None skipped) lies on
    `device`, is contiguous, and has the dtype of the first, f32 or bf16."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA tensors given but CUDA is not available")
    first = None
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: {key} has dtype {t.dtype}; the kernel takes float32 or bfloat16")
        first = first or (key, t.dtype)
        if t.dtype != first[1]:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, {first[0]} {first[1]}; the kernel takes one dtype")
