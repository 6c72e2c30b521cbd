"""Build the port's CUDA kernels at first use and load them with ctypes.

Each of `ssl4gie_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`, all
started together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds rather
than minutes), under `ssl4gie_tpu_torch/build/`, which git ignores. The
library's name carries a hash of the sources, the shared headers
(`csrc/*.cuh`) and the flags, so it is rebuilt only when one of them
changes. Each C entry point launches on the stream it is given and returns
what `cudaGetLastError()` held after the launch; `launch` turns a nonzero
code into an exception. The link needs no `-lcuda`: the one driver call,
the TMA tensor-map encoder of `csrc/tma.cuh`, is reached through the
runtime's `cudaGetDriverEntryPoint`.

Under a process group one process per host builds (local rank 0) while
the others wait at a barrier, then every rank loads the library: N ranks
never start N `nvcc` fan-outs on one `build/` directory.

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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point; pointers and the stream as c_void_p
SIGNATURES = {
    "ssl4gie_attn_fwd": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    "ssl4gie_attn_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "ssl4gie_shear_rotate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "ssl4gie_window_attn_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ssl4gie_window_attn_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _P),
    "ssl4gie_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "ssl4gie_flash_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _P),
    "ssl4gie_mlp_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ssl4gie_mlp_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ssl4gie_mlp_gemm": (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ssl4gie_mlp_smem": (_I, _I),
    "ssl4gie_attn_v2_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ssl4gie_attn_v2_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ssl4gie_attn_savep_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ssl4gie_attn_savep_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ssl4gie_window_attn_v2_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _P),
    "ssl4gie_window_attn_v2_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _P),
    "ssl4gie_layer_norm_fwd": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    "ssl4gie_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P),
    "ssl4gie_nms_topk": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
}
# the float32 instances of the attention kernels take what the bf16 ones take
SIGNATURES.update({
    f"{name}_f32": SIGNATURES[name]
    for name in ("ssl4gie_attn_fwd", "ssl4gie_attn_bwd",
                 "ssl4gie_window_attn_fwd", "ssl4gie_window_attn_bwd",
                 "ssl4gie_flash_fwd", "ssl4gie_flash_bwd")})


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted([*sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libssl4gie_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    `nvcc -c` per source, all running at once, then one link. The
    compilers' output (ptxas register and spill report) is kept beside the
    library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        jobs = []
        for src in sources():
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:          # wait for every compiler
            text = proc.communicate()[0]
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text[-8000:]}")
        out.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr[-8000:]}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _local_rank() -> int:
    """This process's rank on its host (the launcher's, else the global
    rank: one host)."""
    from ssl4gie_tpu_torch.parallel import distributed as dist_lib
    found = dist_lib.detect_environment()
    return found["local_rank"] if found else dist_lib.process_index()


def build_once() -> Path:
    """`build()` in this process, or, under a process group, by local
    rank 0 while every rank waits at a barrier; a failed build raises on
    every rank."""
    from ssl4gie_tpu_torch.parallel import distributed as dist_lib
    if dist_lib.process_count() == 1:
        return build()
    try:
        if _local_rank() == 0:
            build()
    finally:
        dist_lib.barrier()
    out = library_path()
    if not out.exists():
        raise RuntimeError(f"{out} was not built (the build on local rank 0 "
                           "failed)")
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (`build_once`)."""
    lib = ctypes.CDLL(str(build_once()))
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


def launch_on(device: torch.device, name: str, *args) -> None:
    """`launch` on `device`'s current stream, which goes last among the
    entry point's arguments, making `device` current only where it is not.
    The current device and stream are read through torch's raw accessors,
    the ones torch's own generated kernels launch with:
    `torch.cuda.current_stream` builds a Stream object and
    `torch.cuda.device` a context manager at each call, host time on the
    step's critical path at every launch."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        launch(name, *args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            launch(name, *args, torch._C._cuda_getCurrentRawStream(index))
