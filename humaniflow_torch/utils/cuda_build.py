"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled at first
use into `build/torch_kernels/lib<name>-<hash>.so` (hash of the source and
flags, so an edited source is rebuilt).  `build_all` starts one nvcc per
source, all at once, so that a fresh checkout builds in the time of the
slowest source.  Nothing here runs at import time.  `refuse_grad` is the
check every wrapper of a kernel without a backward makes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..configs.paths import REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
# -Xptxas=-v: nvcc reports each kernel's registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is built; returns
    (target, process or None, temporary output path)."""
    target = _target(name)
    if os.path.exists(target):
        return target, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: str, proc, tmp) -> str:
    """Wait for a build started by _start; returns nvcc's output."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict:
    """Compile every csrc/*.cu in parallel; returns {name: nvcc output}."""
    names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, proc, tmp = _start(name)
            _finish(name, target, proc, tmp)
            lib = _libs[name] = ctypes.CDLL(target)
        return lib


def refuse_grad(kernel: str, *tensors):
    """Raise if grad mode is on and a tensor requires grad: a CUDA kernel
    without a backward would hand back a result with no grad_fn and drop the
    gradient without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad under grad mode, and its result would carry "
            f"no gradient. Run it under torch.no_grad(), or detach the inputs"
        )
