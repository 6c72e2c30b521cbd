"""ctypes bindings for the port's C++ loader (port of
`ssl4gie_tpu/data/native_loader.py`; its own copy of the source,
`ssl4gie_tpu_torch/native/loader.cpp`).

The library is built at first use with `g++ -O3 -shared -fPIC -std=c++17
... -ljpeg -lpng -lpthread` into the git-ignored `ssl4gie_tpu_torch/
build/`, under a name that carries a hash of the source and the command,
so it is rebuilt only when one of them changes. Decode and resize run with
the GIL released across a C++ thread pool:
`NativeBatchLoader.load(paths, out_size, make_square) -> (N, S, S, 3)
uint8`, and `augment_classification` runs the host classification
augmentation. A failed build raises with the compiler's message: the
routes that ask for this library (`SSL4GIE_NATIVE_LOADER=1`,
`SSL4GIE_HOST_AUG=1`) never fall back to PIL or to the device for it.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "loader.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join((COMPILER, *FLAGS, *LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libs4gloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of the same hash exists; raise
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [COMPILER, *FLAGS, str(SOURCE), "-o", tmp, *LIBS]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:                     # no compiler
            raise RuntimeError(f"native loader build failed: {' '.join(cmd)}"
                               f": {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.s4g_pool_create.restype = ctypes.c_void_p
            lib.s4g_pool_create.argtypes = [ctypes.c_int]
            lib.s4g_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.s4g_load_batch.restype = ctypes.c_int
            lib.s4g_load_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte)]
            lib.s4g_augment_classification.restype = ctypes.c_int
            lib.s4g_augment_classification.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


class NativeBatchLoader:
    """A C++ thread pool of `num_threads` (default: every core)."""

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = library()
        n = num_threads or max(os.cpu_count() or 1, 1)
        self._pool = self._lib.s4g_pool_create(n)

    def load(self, paths: List[str], out_size: int,
             make_square: bool = False) -> np.ndarray:
        """Decode and resize `paths` (JPEG/PNG) to (N, out_size, out_size,
        3) uint8; `make_square` pads each image to its longer side first.
        IOError names the first file that failed."""
        n = len(paths)
        out = np.empty((n, out_size, out_size, 3), np.uint8)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = self._lib.s4g_load_batch(
            self._pool, arr, n, out_size, int(make_square),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc != 0:
            raise IOError(f"native decode failed for {paths[rc - 1]}")
        return out

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.s4g_pool_destroy(self._pool)
            self._pool = None


def augment_classification(loader: NativeBatchLoader, imgs_u8: np.ndarray,
                           seed: int) -> np.ndarray:
    """The host classification augmentation (jitter, blur, flips, rotation,
    normalize) across the pool: (N, S, S, 3) uint8 -> float32 normalized,
    a function of `seed`. A statistical match of `data/augment.py`'s device
    pipeline, for hosts with cores to spare."""
    n, S = imgs_u8.shape[0], imgs_u8.shape[1]
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    out = np.empty((n, S, S, 3), np.float32)
    loader._lib.s4g_augment_classification(
        loader._pool, imgs_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, S, ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
