"""Where the time of the resident attention backward goes (#10, #11 and
#12, the persistent TMA kernel `res_bwd_tma` of
`csrc/attention_resident.cuh`): builds the two entries
(`csrc/attention_variants.cu`, `csrc/window_attention_v2.cu`) again with
one change to the header's backward each, times each backward at every
configuration the harness legs launch, back to back (20 calls between two CUDA events, after 3 warm-up
calls) per variant, and prints one line per variant and configuration with
ptxas's registers and spills of the backward kernels and the largest
difference from the plain version:

- base: the header as it is;
- no_persistent: as many blocks as work items (ceil(seqs / G) H, the grid
  of the cp.async kernels), in place of at most one block an SM;
- no_producer: no producer warpgroup; thread 0 of consumer 0 stores the
  last sequence's outputs and loads the next sequence before each one (256
  threads a block; #11 keeps its producer, which also feeds the P rings);
- in_order: every chunk's products are waited for at the end of its step,
  so no product runs under the next chunk's exponent (#11 waits so
  already);
- no_prefetch: the producer does not bring the next sequence into L2
  while this one is computed (#11 never does);
- no_dq_sums: the dQ turns skip their shared-memory sums (the turns' order
  and barriers stay; dQ is wrong): what the f32 sums cost;
- loads_only: the consumers skip every key tile (no product, no
  exponent): the producer's loads and stores and the consumers' prologue,
  the memory side of the time (#11: the consumers also skip delta's
  products, and take and release every P box unread);
- compute_only: the producer loads the block's first sequence (and its
  lse) and no more, stores nothing, and the consumers compute every
  sequence from that stage (on what the last one left there): the compute
  side of the time (#11: each P slot is loaded once, then handed over as
  it is);
- p_ring2: #11's P ring two boxes deep a consumer in place of three (the
  other rows build the same code).

All but no_dq_sums and the loads_only and compute_only compute the same
function. The fused kernel is the
only form built (one kernel for dQ, dK and dV), so there is no split
variant. Then it counts the `HGMMA` (wgmma), `UTMALDG` (TMA load) and
`UTMASTG` (TMA store) instructions of the backward kernels in base's
library (`cuobjdump -sass`). The variants are built in a temporary
directory with the compile flags of `kernels/_build.py`, all compilers
started together:

    PYTHONPATH=<checkout> python3 <this file> [variant ...]

(all variants if none is named).
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ssl4gie_tpu_torch.benchmarks.ablate_resident_forward import (
    finish_build, sass_count, start_build)
from ssl4gie_tpu_torch.benchmarks.bench_attention_core import back_to_back_ms
from ssl4gie_tpu_torch.kernels import attention_variants as av

KERNEL = "res_bwd_tma"
SECTION = "// ------------------------------------------------ backward (#10"
VARIANTS = {
    "base": [],
    "no_persistent": [("constexpr bool kResPersistent = true;",
                       "constexpr bool kResPersistent = false;")],
    "no_producer": [("constexpr bool kResProducer = true;",
                     "constexpr bool kResProducer = false;")],
    "in_order": [("      wgmma_ss_n64t<1, 1>(dqp, sd + kk * kStep, kd + kk * "
                  "kStep, kk);\n    wg_commit();\n",
                  "      wgmma_ss_n64t<1, 1>(dqp, sd + kk * kStep, kd + kk * "
                  "kStep, kk);\n    wg_commit();\n    wg_wait0();\n")],
    "no_prefetch": [("    if (!kSaveP && ld.more(a)) {\n      const int ncol",
                     "    if (false) {\n      const int ncol")],
    "no_dq_sums": [("    if (W == 64 || wr == 0) {             // W = 16: warp 0's "
                    "rows only", "    if (false) {")],
    "loads_only": [("    for (int kt = w; kt < n_kt; kt += 2)\n",
                    "    for (int kt = w; kt < 0; kt += 2)\n"),
                   ("      for (int qt = w; qt < n_kt; qt += 2)\n"
                    "        savep_delta<NK>(smem, qt, a.N, ring);\n",
                    "      for (int i = 0; i < (n_kt - w + 1) / 2 * (n_kt + "
                    "T::kChunks); ++i) {\n        ring.take();\n"
                    "        ring.give();\n      }\n")],
    "compute_only": [
        ("        while (loader.ld.more(a)) loader.step(a);\n"
         "        loader.drain(a);\n",
         "        loader.step(a);\n"),
        ("        for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j)\n"
         "          load_lse<NK>",
         "        for (SeqWalk sw(a); j < 1; sw.next(a), ++j)\n"
         "          load_lse<NK>"),
        ("    mbar_wait(full, j & 1);\n",
         "    if (j == 0) mbar_wait(full, 0);\n"),
        ("    if (row < a.N) {\n", "    if (row < a.N && n < kPRing) {\n")],
    "p_ring2": [("constexpr int kPRing = 3;", "constexpr int kPRing = 2;")],
}
ENTRIES = ("ssl4gie_attn_v2_bwd", "ssl4gie_window_attn_v2_bwd",
           "ssl4gie_attn_savep_bwd")
HEADS, SCALE = 12, 0.125


def rows(gen) -> dict:
    """row -> (entry, argument maker, plain dqkv): #10 at (64, 197, 3*768)
    for every harness (G, Nb), #11 at the same shape (its harness leg's G 2,
    Nb 208), #12 on the (4, 64, 64, 3*768) grid at G 1, 2, 4, each from the
    plain forward's out and lse (#11: P); the maker takes the output's
    pointer."""
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device="cuda").to(torch.bfloat16)
    out = {}
    qkv, dout = rand(64, 197, 3 * 768), rand(64, 197, 768)
    o, lse = av.packed_attention_v2_fwd_plain(qkv, HEADS, SCALE)
    lse = lse.contiguous()
    g_p = av.packed_attention_v2_bwd_plain(qkv, dout, HEADS, SCALE)
    for G, nb in ((2, 256), (4, 256), (2, 208), (4, 208)):
        out[f"#10 G {G} Nb {nb}"] = (
            ENTRIES[0],
            lambda d, G=G, nb=nb: (qkv.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), dout.data_ptr(), d, 64,
                                   197, HEADS, nb, G, SCALE), qkv, g_p)
    _, p = av.packed_attention_save_p_fwd_plain(qkv, HEADS, SCALE, 208)
    p_p = av.packed_attention_save_p_bwd_plain(qkv, p, dout, HEADS, SCALE)
    out["#11 G 2 Nb 208"] = (
        ENTRIES[2],
        lambda d: (qkv.data_ptr(), p.data_ptr(), dout.data_ptr(), d, 64, 197,
                   HEADS, 208, 2, SCALE), qkv, p_p)
    wqkv, wdout = rand(4, 64, 64, 3 * 768), rand(4, 64, 64, 768)
    wo, wlse = av.window_attention_v2_fwd_plain(wqkv, HEADS, 16, SCALE)
    wlse = wlse.contiguous()
    wg_p = av.window_attention_v2_bwd_plain(wqkv, wdout, HEADS, 16, SCALE)
    for G in (1, 2, 4):
        out[f"#12 G {G}"] = (
            ENTRIES[1],
            lambda d, G=G: (wqkv.data_ptr(), wo.data_ptr(), wlse.data_ptr(),
                            wdout.data_ptr(), d, 4, 64, 64, 16, HEADS, G,
                            SCALE), wqkv, wg_p)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_resident_backward: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cases = rows(torch.Generator(device="cuda").manual_seed(0))
    names = sys.argv[1:] or list(VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        works = {name: Path(tmp) / name for name in names}
        jobs = {name: start_build(VARIANTS[name], works[name], SECTION)
                for name in names}
        for name in names:
            lib, path, regs = finish_build(jobs[name], works[name], KERNEL,
                                           ENTRIES)
            print(f"{name}: ptxas " + "; ".join(
                f"{k}: {r} registers, {s} B spilled" for k, r, s in regs),
                flush=True)
            for row, (entry, args, like, g_p) in cases.items():
                g = torch.empty_like(like)
                argv = args(g.data_ptr())
                call = lambda: getattr(lib, entry)(
                    *argv, torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    raise RuntimeError(f"{name} {row}: launch failed")
                torch.cuda.synchronize()
                err = ((g.float() - g_p.float()).abs().max()
                       / g_p.float().abs().max()).item()
                print(f"{name} {row}: {back_to_back_ms(call):.4f} ms a call "
                      f"back to back, max|err| {err:.3g} of the largest  "
                      f"[{card}]", flush=True)
            if name == "base":
                print(f"base: {sass_count(path, KERNEL)}  [{card}]",
                      flush=True)


if __name__ == "__main__":
    main()
