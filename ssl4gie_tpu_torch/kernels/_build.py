"""Build the port's CUDA kernels at first use and load them with ctypes.

All of `ssl4gie_tpu_torch/csrc/*.cu` is compiled by one `nvcc` call into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds rather than minutes), under `ssl4gie_tpu_torch/build/`, which
git ignores. The library's name carries a hash of the sources and the flags,
so it is rebuilt only when one of them changes. Each C entry point launches on
the stream it is given and returns what `cudaGetLastError()` held after the
launch; `check` turns a nonzero code into an exception.

Nothing here runs at import: the CPU path never builds or loads anything.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point; pointers and the stream as c_void_p
SIGNATURES = {
    "ssl4gie_attn_fwd": (_P, _P, _P, _I, _I, _I, _F, _P),
    "ssl4gie_attn_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "ssl4gie_shear_rotate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libssl4gie_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists. The
    compiler's output (ptxas register and spill report) is kept beside the
    library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr[-8000:]}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ssl4gie_error_string.argtypes = (ctypes.c_int,)
    lib.ssl4gie_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if the launch left a CUDA error."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.ssl4gie_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
