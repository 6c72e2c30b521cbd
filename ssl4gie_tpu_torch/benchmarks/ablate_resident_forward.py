"""Where the time of the resident attention forward goes (#10 and #12, the
persistent TMA kernel `res_fwd_tma` of `csrc/attention_resident.cuh`):
builds the two entries (`csrc/attention_variants.cu`,
`csrc/window_attention_v2.cu`) again with one change to the header each,
times each forward at every configuration the harness legs launch, back to
back (20 calls between two CUDA events, after 3 warm-up calls) per
variant, and prints one line per variant and configuration with ptxas's
registers and spills of the forward kernels and the largest difference
from the plain version:

- base: the header as it is;
- no_persistent: as many blocks as work items (ceil(seqs / G) H, the grid
  of the cp.async kernels), in place of at most one block an SM;
- no_producer: no producer warp; thread 0 of consumer 0 issues the next
  sequence's loads and the last one's store before each sequence (256
  threads a block);
- no_stagger: the two consumers start together (no named barrier
  between their first products);
- all_columns: the exponent of every key column, those past N too;
- loads_only: the consumers skip every tile (no product, no softmax):
  the producer's loads and stores alone, the memory side of the time;
- compute_only: the producer loads the block's first two sequences and
  no more, stores nothing, and the consumers compute every sequence from
  those two stages: the compute side of the time.

All but the last two compute the same function. Then it counts the `HGMMA` (wgmma),
`UTMALDG` (TMA load) and `UTMASTG` (TMA store) instructions of the forward
kernels in base's library (`cuobjdump -sass`). The variants are built in a
temporary directory with the compile flags of `kernels/_build.py`, all
compilers started together:

    PYTHONPATH=<checkout> python3 <this file> [variant ...]

(all variants if none is named).
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ssl4gie_tpu_torch.benchmarks.bench_attention_core import back_to_back_ms
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import attention_variants as av

VARIANTS = {
    "base": [],
    "no_persistent": [("constexpr bool kResPersistent = true;",
                       "constexpr bool kResPersistent = false;")],
    "no_producer": [("constexpr bool kResProducer = true;",
                     "constexpr bool kResProducer = false;")],
    "no_stagger": [("  if (first) named_arrive(1, 256);\n", ""),
                   ("  if (w == 1) named_sync(1, 256);", "")],
    "all_columns": [("sc[j][e] = live && j * 8 < N", "sc[j][e] = live")],
    "loads_only": [("    for (int qt = w; qt < n_qt; qt += 2)\n",
                    "    for (int qt = w; qt < 0; qt += 2)\n"),
                   ("  if (w == 1) named_sync(1, 256);", "")],
    "compute_only": [
        ("        while (loader.ld.more(a)) loader.step(a);\n"
         "        loader.drain(a);\n",
         "        for (int k = 0; k < 2 && loader.ld.more(a); ++k)\n"
         "          loader.step(a);\n"),
        ("    mbar_wait(full + s, (j >> 1) & 1);\n",
         "    if (j < 2) mbar_wait(full + s, 0);\n")],
}
SOURCES = ("attention_variants.cu", "window_attention_v2.cu")
ENTRIES = ("ssl4gie_attn_v2_fwd", "ssl4gie_window_attn_v2_fwd")
HEADS, SCALE = 12, 0.125


def start_build(variant: list, work: Path, section: str = "") -> list:
    """Copy csrc/ into `work`, apply the variant (each text replaced where
    it first occurs from the header's line `section` on, else where it
    first occurs), start one nvcc a source."""
    src = work / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    header = src / "attention_resident.cuh"
    text = header.read_text()
    start = text.index(section) if section else 0
    for old, new in variant:
        at = text.find(old, start)
        at = text.find(old) if at < 0 else at
        if at < 0:
            raise RuntimeError(f"variant text not found: {old[:60]!r}")
        text = text[:at] + new + text[at + len(old):]
    header.write_text(text)
    jobs = []
    for name in SOURCES:
        obj = work / f"{Path(name).stem}.o"
        jobs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-c", "-o", str(obj),
             str(src / name)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_build(jobs: list, work: Path, kernel: str = "res_fwd_tma",
                 entries=ENTRIES) -> tuple[ctypes.CDLL, Path, list]:
    """Wait for the compilers, link, load; ptxas's (kernel, registers,
    spill stores) of the instances of `kernel`."""
    log = ""
    for _, proc in jobs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text[-4000:]}")
    lib = work / "variant.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib), *(str(obj) for obj, _ in jobs)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib))
    for name in entries:
        getattr(fn, name).argtypes = _build.SIGNATURES[name]
        getattr(fn, name).restype = ctypes.c_int
    regs = []
    for m in re.finditer(rf"Compiling entry function '(\w*{kernel}\w*)'"
                         r".*?(\d+) bytes spill stores.*?Used (\d+) "
                         r"registers", log, re.S):
        nk, window, save_p = re.search(r"ILi(\d+)ELb(\d)ELb(\d)E",
                                       m.group(1)).groups()
        kind = (f"{'window' if window == '1' else 'dense'} NK {nk}"
                f"{' save-P' if save_p == '1' else ''}")
        regs.append((kind, int(m.group(3)), int(m.group(2))))
    return fn, lib, sorted(set(regs))


def rows(gen) -> dict:
    """row -> (entry, output shape, lse shape, argument maker, plain out):
    #10 at (64, 197, 3*768) for every harness (G, Nb), #12 on the (4, 64,
    64, 3*768) grid at G 1, 2, 4; the maker takes the output's and the
    lse's pointers."""
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device="cuda").to(torch.bfloat16)
    out = {}
    qkv = rand(64, 197, 3 * 768)
    o_p = av.packed_attention_v2_fwd_plain(qkv, HEADS, SCALE)[0]
    for G, nb in ((2, 256), (4, 256), (2, 208), (4, 208)):
        out[f"#10 G {G} Nb {nb}"] = (
            ENTRIES[0], (64, 197, 768), (64, HEADS, 197),
            lambda o, l, G=G, nb=nb: (qkv.data_ptr(), o, l, 64, 197, HEADS,
                                      nb, G, SCALE), o_p)
    wqkv = rand(4, 64, 64, 3 * 768)
    wo_p = av.window_attention_v2_fwd_plain(wqkv, HEADS, 16, SCALE)[0]
    for G in (1, 2, 4):
        out[f"#12 G {G}"] = (
            ENTRIES[1], (4, 64, 64, 768), (64, HEADS, 256),
            lambda o, l, G=G: (wqkv.data_ptr(), o, l, 4, 64, 64, 16, HEADS,
                               G, SCALE), wo_p)
    return out


def sass_count(lib: Path, kernel: str = "res_fwd_tma") -> str:
    """HGMMA, UTMALDG and UTMASTG instructions in the instances of
    `kernel`."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, first, current = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = kernel in line
        elif current:
            for op in ("HGMMA", "UTMALDG", "UTMASTG"):
                if re.search(rf"\b{op}\b", line):
                    counts[op] = counts.get(op, 0) + 1
                    first.setdefault(
                        op, " ".join(line.split("*/")[1].split()[:5]))
    return "; ".join(f"{counts.get(op, 0)} {op} (e.g. "
                     f"{first.get(op, '-').rstrip(' ;')})"
                     for op in ("HGMMA", "UTMALDG", "UTMASTG"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_resident_forward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cases = rows(torch.Generator(device="cuda").manual_seed(0))
    names = sys.argv[1:] or list(VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        works = {name: Path(tmp) / name for name in names}
        jobs = {name: start_build(VARIANTS[name], works[name])
                for name in names}
        for name in names:
            lib, path, regs = finish_build(jobs[name], works[name])
            print(f"{name}: ptxas " + "; ".join(
                f"{k}: {r} registers, {s} B spilled" for k, r, s in regs),
                flush=True)
            for row, (entry, o_shape, l_shape, args, o_p) in cases.items():
                o = torch.empty(o_shape, device="cuda", dtype=torch.bfloat16)
                lse = torch.empty(l_shape, device="cuda")
                argv = args(o.data_ptr(), lse.data_ptr())
                call = lambda: getattr(lib, entry)(
                    *argv, torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    raise RuntimeError(f"{name} {row}: launch failed")
                torch.cuda.synchronize()
                err = ((o.float() - o_p.float()).abs().max()
                       / o_p.float().abs().max()).item()
                print(f"{name} {row}: {back_to_back_ms(call):.4f} ms a call "
                      f"back to back, max|err| {err:.3g} of the largest  "
                      f"[{card}]", flush=True)
            if name == "base":
                print(f"base: {sass_count(path)}  [{card}]", flush=True)


if __name__ == "__main__":
    main()
