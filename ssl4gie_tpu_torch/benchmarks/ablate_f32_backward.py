"""Where the float32 flash backward's time goes (#7 at (48, 4096, 64), the
3xTF32 kernels of `csrc/attention_tf32.cuh`): builds the flash entry
(`csrc/flash_attention.cu`) again with one change to the header each, times
`ssl4gie_flash_bwd_f32` (dq then dk/dv) over 10 calls per variant, and
prints one line per variant with ptxas's register counts:

- base: the header as it is;
- cvt: TF32 rounding by `cvt.rna.tf32.f32` instead of the integer add and
  mask (the same function);
- one_warpgroup: 128 threads a block (warpgroup 0 alone loads and splits);
- dq_only: the dk/dv kernel not launched;
- no_split: the streamed tiles not split (raw values read as hi, lo and the
  transposed copies stale; the time without the split pass).

Only `base` computes the right gradients. The variants are built in a
temporary directory with the compile flags of `kernels/_build.py`:

    PYTHONPATH=<checkout> python3 <this file>
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import flash_attention as fa

VARIANTS = {
    "base": [],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
             "  unsigned r;\n"
             '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
             "  return r;\n")],
    "one_warpgroup": [("constexpr int kTf32Threads = 256;",
                       "constexpr int kTf32Threads = 128;")],
    "dq_only": [("  attn_bwd_dkv_tf32<D, Rows><<<grid, kTf32Threads, "
                 "dkv_smem, s>>>(",
                 "  if (0) attn_bwd_dkv_tf32<D, Rows><<<grid, kTf32Threads, "
                 "dkv_smem, s>>>(")],
    "no_split": [("    split_tile<T, D, true>(Kh, Kl, KTh, KTl);\n"
                  "    split_tile<T, D, false>(Vh, Vl, nullptr, nullptr);\n",
                  ""),
                 ("    split_tile<T, D, true>(Qh, Ql, QTh, QTl);\n"
                  "    split_tile<T, D, true>(Gh, Gl, GTh, GTl);\n", "")],
}
BH, N, D = 48, 4096, 64


def build(variant: list, work: Path) -> tuple[ctypes.CDLL, list[str]]:
    src = work / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    header = src / "attention_tf32.cuh"
    text = header.read_text()
    for old, new in variant:
        if old not in text:
            raise RuntimeError(f"variant text not found: {old[:60]!r}")
        text = text.replace(old, new)
    header.write_text(text)
    lib = work / "flash.so"
    proc = subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
                           "-o", str(lib), str(src / "flash_attention.cu")],
                          capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(str(lib))
    fn.ssl4gie_flash_bwd_f32.argtypes = _build.SIGNATURES[
        "ssl4gie_flash_bwd_f32"]
    fn.ssl4gie_flash_bwd_f32.restype = ctypes.c_int
    return fn, re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_f32_backward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((BH, N, D), generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, D ** -0.5)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    for name, variant in VARIANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            lib, regs = build(variant, Path(tmp))
            args = [t.data_ptr() for t in (q, k, v, o, lse, do, delta, dq,
                                           dk, dv)]
            call = lambda: lib.ssl4gie_flash_bwd_f32(
                *args, BH, N, N, D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            print(f"{name}: {start.elapsed_time(end) / 10:.4f} ms per call, "
                  f"registers {regs}  [{card}]", flush=True)


if __name__ == "__main__":
    main()
