"""Where the float32 attention forward's time goes (#1 at Dh 64, 32 and 80,
#4 and #6 at their paths' shapes, the 3xTF32 kernel `attn_fwd_tf32` of
`csrc/attention_tf32.cuh`): builds the three attention entries
(`csrc/dense_attention.cu`, `window_attention.cu`, `flash_attention.cu`)
again with one change to the header each, times each float32 forward entry
back to back (20 calls between two CUDA events, after 3 warm-up calls) per
variant, and prints one line per variant and row with ptxas's registers and
spills of the forward kernels and the largest difference from the plain
version:

- base: the header as it is;
- g1: one warpgroup a block at every head width (64 query rows);
- g2: two warpgroups a block at every head width (128 query rows, each
  streamed tile split once for both);
- no_stagger: the two warpgroups issue S = Q.K^T together (no named
  barrier between them);
- one_accumulator: P.V accumulated into the output accumulator itself,
  rescaled by alpha before each tile's product (the same function, one
  chain of tensor-core accumulations a row instead of a rounded FMA a
  tile);
- no_split: the streamed K and V tiles not split (the raw K read as hi,
  K lo and V^T never written; the time without the split pass of the
  loop).

All but no_split compute the right function. Then it counts the
`HGMMA.*.F32.TF32` instructions in the forward kernels of base's library
(`cuobjdump -sass`), which shows that they run on the tensor cores. The
variants are built in a temporary directory with the compile flags of
`kernels/_build.py`, all compilers started together:

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

from ssl4gie_tpu_torch.core.config import float32_policy
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import window_attention as wa

GROUPS = "constexpr int kFwdGroups = D == 80 ? 1 : 2;"
VARIANTS = {
    "base": [],
    "g1": [(GROUPS, "constexpr int kFwdGroups = 1;")],
    "g2": [(GROUPS, "constexpr int kFwdGroups = 2;")],
    "no_stagger": [("    if (G == 2 && wg == 1) named_sync(1, 256);\n", ""),
                   ("    if (G == 2 && wg == 0) named_arrive(1, 256);\n", "")],
    "one_accumulator": [
        ("        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);\n",
         "        acc[n][e] = part[n][e];\n"),
        ("tf32x3_rs<D, 0, NS, NS, true>(part,", "tf32x3_rs<D, 0, NS>(part,"),
        ("      l[hf] = l[hf] * alpha[hf] + sum;\n",
         "      l[hf] = l[hf] * alpha[hf] + sum;\n"
         "      for (int n = 0; n < NO; ++n) {\n"
         "        part[n][2 * hf] *= alpha[hf];\n"
         "        part[n][2 * hf + 1] *= alpha[hf];\n"
         "      }\n")],
    "no_split": [
        ("    split_tile<T, D, false, true, kT>(Kh, Kl, nullptr, nullptr);\n"
         "    split_tile<T, D, true, false, kT>(Kh + XT, nullptr, VTh, VTl);\n",
         "")],
}
SOURCES = ("dense_attention.cu", "window_attention.cu", "flash_attention.cu")
ENTRIES = ("ssl4gie_attn_fwd_f32", "ssl4gie_window_attn_fwd_f32",
           "ssl4gie_flash_fwd_f32")
RUNS = 20


def start_build(variant: list, work: Path) -> list:
    """Copy csrc/ into `work`, apply the variant, start one nvcc a source."""
    src = work / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    header = src / "attention_tf32.cuh"
    text = header.read_text()
    for old, new in variant:
        if old not in text:
            raise RuntimeError(f"variant text not found: {old[:60]!r}")
        text = text.replace(old, new)
    header.write_text(text)
    jobs = []
    for name in SOURCES:
        obj = work / f"{Path(name).stem}.o"
        jobs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-c", "-o", str(obj),
             str(src / name)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_build(jobs: list, work: Path) -> tuple[ctypes.CDLL, Path, list]:
    """Wait for the compilers, link, load; ptxas's (kernel, registers,
    spill stores) of the forward kernels."""
    log = ""
    for _, proc in jobs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text[-4000:]}")
    lib = work / "fwd.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib), *(str(obj) for obj, _ in jobs)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        getattr(fn, name).argtypes = _build.SIGNATURES[name]
        getattr(fn, name).restype = ctypes.c_int
    regs = []
    for m in re.finditer(r"Compiling entry function '(\w*attn_fwd_tf32\w*)'"
                         r".*?(\d+) bytes spill stores.*?Used (\d+) "
                         r"registers", log, re.S):
        name = m.group(1)
        kind = ("window" if "Window" in name else "dense") + re.search(
            r"ILi(\d+)ELi(\d+)", name).expand(r" Dh \1 G \2")
        regs.append((kind, int(m.group(3)), int(m.group(2))))
    return fn, lib, sorted(set(regs))


def rows(gen) -> dict:
    """row -> (entry, input, output shape, lse shape, argument maker, plain
    (out, lse)) at the paths' shapes; the argument maker takes the output's
    and the lse's pointers."""
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    out = {}
    for name, (b, n, heads, dh) in (("dense_dh64", (64, 197, 12, 64)),
                                    ("dense_dh32", (256, 197, 16, 32)),
                                    ("dense_dh80", (64, 180, 16, 80))):
        qkv, scale = rand(b, n, 3 * heads * dh), dh ** -0.5
        out[name] = (ENTRIES[0], qkv, (b, n, heads * dh), (b, heads, n),
                     lambda o, l, qkv=qkv, b=b, n=n, heads=heads, dh=dh,
                     scale=scale: (qkv.data_ptr(), o, l, b, n, heads, dh,
                                   scale),
                     lambda qkv=qkv, heads=heads, scale=scale:
                         da.fused_qkv_attention_fwd_plain(qkv, heads, scale))
    qkv = rand(4, 64, 64, 3 * 768)
    out["window"] = (ENTRIES[1], qkv, (4, 64, 64, 768), (64, 12, 256),
                     lambda o, l, qkv=qkv: (qkv.data_ptr(), o, l, 4, 64, 64,
                                            16, 12, 0.125),
                     lambda qkv=qkv: wa.windowed_attention_fwd_plain(
                         qkv, 12, 16, 0.125))
    for name, bh in (("flash", 48), ("flash_eval", 24)):
        q, k, v = (rand(bh, 4096, 64) for _ in range(3))
        out[name] = (ENTRIES[2], q, (bh, 4096, 64), (bh, 4096),
                     lambda o, l, q=q, k=k, v=v, bh=bh: (
                         q.data_ptr(), k.data_ptr(), v.data_ptr(), o, l, bh,
                         4096, 4096, 0.125),
                     lambda q=q, k=k, v=v: fa.flash_attention_fwd_plain(
                         q, k, v, 0.125))
    return out


def back_to_back_ms(call) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / RUNS


def hgmma_count(lib: Path) -> str:
    """HGMMA.*.F32.TF32 instructions in the forward kernels of `lib`."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, first, current = {}, "", None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split(":", 1)[1].strip()
            current = current if "attn_fwd_tf32" in current else None
        elif current and re.search(r"HGMMA\.\S*F32\.TF32", line):
            counts[current] = counts.get(current, 0) + 1
            first = first or " ".join(line.split("*/")[1].split()[:6])
    return (f"{sum(counts.values())} HGMMA.*.F32.TF32 in {len(counts)} "
            f"forward kernels, e.g. {first.rstrip(' ;')}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_f32_forward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    float32_policy()                 # the plain version in full float32
    cases = rows(torch.Generator(device="cuda").manual_seed(0))
    plain = {name: c[5]() for name, c in cases.items()}
    with tempfile.TemporaryDirectory() as tmp:
        works = {name: Path(tmp) / name for name in VARIANTS}
        jobs = {name: start_build(variant, works[name])
                for name, variant in VARIANTS.items()}
        for name in VARIANTS:
            lib, path, regs = finish_build(jobs[name], works[name])
            print(f"{name}: ptxas " + "; ".join(
                f"{k}: {r} registers, {s} B spilled" for k, r, s in regs),
                flush=True)
            for row, (entry, x, o_shape, l_shape, args, _) in cases.items():
                o = torch.empty(o_shape, device="cuda")
                lse = torch.empty(l_shape, device="cuda")
                argv = args(o.data_ptr(), lse.data_ptr())
                call = lambda: getattr(lib, entry)(
                    *argv, torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    raise RuntimeError(f"{name} {row}: launch failed")
                torch.cuda.synchronize()
                o_p, _ = plain[row]
                err = ((o - o_p).abs().max() / o_p.abs().max()).item()
                print(f"{name} {row}: {back_to_back_ms(call):.4f} ms a call "
                      f"back to back, max|err| {err:.3g} of the largest  "
                      f"[{card}]", flush=True)
            if name == "base":
                print(f"base: {hgmma_count(path)}  [{card}]", flush=True)


if __name__ == "__main__":
    main()
