"""ctypes binding of the native JPEG loader (`native/dataloader.cc`):
threaded JPEG decode and bilinear resize straight into a caller-owned
float32 NHWC buffer, for the training backgrounds.

The PyTorch package's counterpart of `humaniflow_tpu/data/native_loader.py`.
The library is built with g++ at first use into
`build/torch_kernels/libhfdataloader-<hash>.so` (the hash of the source and
the command, as utils/cuda_build.py names its kernels), never into
`native/`.  Without g++ or libjpeg the build fails, `native_available()`
is False, `build_error()` says why, and `decode_jpeg_batch` decodes with
OpenCV instead, as the JAX package does.
"""

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..configs.paths import REPO_ROOT

SOURCE = os.path.join(REPO_ROOT, "native", "dataloader.cc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
_BUILD = ("g++", "-O3", "-shared", "-fPIC")
_LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _target() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(_BUILD + _LIBS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libhfdataloader-{digest[:16]}.so")


def _load_library() -> Optional[ctypes.CDLL]:
    """The built library, building it on first use; None if it cannot be
    built or loaded (the reason is kept for build_error())."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            target = _target()
            if not os.path.exists(target):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{target}.{os.getpid()}.tmp"
                proc = subprocess.run([*_BUILD, "-o", tmp, SOURCE, *_LIBS], capture_output=True, text=True,
                                      timeout=120)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for native/dataloader.cc:\n{proc.stderr.strip()}")
                os.replace(tmp, target)
            lib = ctypes.CDLL(target)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # no g++ or libjpeg, or it does not load
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.hf_decode_jpeg_batch.restype = ctypes.c_int
        lib.hf_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native decoder is built and loaded (building it now if
    it has not been tried)."""
    return _load_library() is not None


def build_error() -> Optional[str]:
    """Why the native decoder could not be built or loaded, or None."""
    _load_library()
    return _error


def decode_jpeg_batch(paths: List[str], out_wh: int, num_threads: int = 4,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode and resize a batch of JPEGs → (N, out_wh, out_wh, 3) float32
    RGB in [0, 1]; a file that does not decode gives zeros.  Uses the native
    threaded decoder when it is available, else OpenCV."""
    n = len(paths)
    if out is None:
        out = np.empty((n, out_wh, out_wh, 3), np.float32)
    elif out.shape != (n, out_wh, out_wh, 3) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {(n, out_wh, out_wh, 3)}")
    lib = _load_library()
    if lib is not None:
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lib.hf_decode_jpeg_batch(c_paths, n, out_wh, out_wh,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
        return out

    import cv2

    for i, p in enumerate(paths):
        img = cv2.imread(p)
        if img is None:
            out[i] = 0.0
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        out[i] = cv2.resize(img, (out_wh, out_wh), interpolation=cv2.INTER_LINEAR) / 255.0
    return out


class PrefetchingLoader:
    """Double-buffered background prefetcher over an index-batched sampler:
    a worker thread makes batch i + 1 while batch i is used."""

    def __init__(self, make_batch_fn, num_batches: int):
        self._make = make_batch_fn
        self._num = num_batches

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            for i in range(self._num):
                q.put(self._make(i))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
