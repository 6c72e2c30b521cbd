"""Times the resident-sequence kernels of the kernel A/B harnesses on the
card at every configuration a harness leg launches: #10's forward and
backward (`attention_variants.attention_v2_fwd` / `_bwd` at G 2 and 4, Nb
256 and 208) and #11's (save-P, G 2, Nb 208) at the classification shape
(64, 197, 3*768), 12 heads of 64; #12's (`window_v2_fwd` / `_bwd` at G 1,
2, 4) on the detection grid (4, 64, 64, 3*768) with 16 x 16 windows; and,
beside them, the production twins on the same inputs: the streaming
forwards #1 and #4 and backwards #2 and #5. Each per call (median of 20
CUDA-event readings) and back to back (20 calls between two events). Also
`F.scaled_dot_product_attention` on the same inputs, split into contiguous
(B, H, N, Dh) tensors outside the timing, the one PyTorch call that
computes the kernels' function: its forward, and its backward alone
(autograd of a recorded forward). Prints one JSON line with the card's name
and power limit.

It imports only the kernel modules, which every checkout of the port since
the harnesses has, so that two checkouts can be compared in one call on one
card:

    PYTHONPATH=<checkout> python3 <this file>

times the kernels of the `ssl4gie_tpu_torch` under <checkout>.
"""

from __future__ import annotations

import json
import subprocess

import torch

import ssl4gie_tpu_torch
from ssl4gie_tpu_torch.benchmarks.bench_attention_core import (back_to_back_ms,
                                                               per_call_ms)
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import attention_variants as av
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import window_attention as wa

HEADS, DH, TOKENS, BATCH = 12, 64, 197, 64       # classification
GRID_B, GRID, WINDOW = 4, 64, 16                 # detection
SCALE = DH ** -0.5
DENSE_FWD = ((2, 256), (4, 256), (2, 208), (4, 208))   # (G, Nb)
DENSE_BWD = ((2, 256), (4, 256), (2, 208), (4, 208))
WINDOW_G = (1, 2, 4)


def heads(x: torch.Tensor) -> torch.Tensor:
    """(S, N, C) -> contiguous (S, H, N, Dh)."""
    S, N, _ = x.shape
    return x.reshape(S, N, HEADS, DH).transpose(1, 2).contiguous()


def sdpa_call(qkv: torch.Tensor):
    """SDPA's forward on packed (S, N, 3C) qkv, split once into contiguous
    (S, H, N, Dh) q, k, v."""
    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, scale=SCALE)


def sdpa_bwd_call(qkv: torch.Tensor, dout: torch.Tensor):
    """SDPA's backward alone: autograd of one recorded forward on the split
    q, k, v, with dO (S, N, C) split the same way."""
    xs = [heads(t).requires_grad_(True) for t in qkv.chunk(3, dim=-1)]
    o = torch.nn.functional.scaled_dot_product_attention(*xs, scale=SCALE)
    g = heads(dout)
    return lambda: torch.autograd.grad(o, xs, g, retain_graph=True)


def cases() -> dict:
    """name -> call on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device="cuda").to(torch.bfloat16)
    C = HEADS * DH
    out = {}
    qkv, dout = rand(BATCH, TOKENS, 3 * C), rand(BATCH, TOKENS, C)
    o, lse = av.attention_v2_fwd(qkv, HEADS, SCALE)
    o1, lse1 = da.attention_fwd(qkv, HEADS, SCALE)
    out["dense_1_fwd"] = lambda: da.attention_fwd(qkv, HEADS, SCALE)
    out["dense_sdpa_fwd"] = sdpa_call(qkv)
    out["dense_2_bwd"] = lambda: da.attention_bwd(qkv, o1, lse1, dout, HEADS,
                                                  SCALE)
    out["dense_sdpa_bwd"] = sdpa_bwd_call(qkv, dout)
    for G, nb in DENSE_FWD:
        out[f"dense_10_fwd_g{G}_nb{nb}"] = (
            lambda G=G, nb=nb: av.attention_v2_fwd(qkv, HEADS, SCALE, G, nb))
    for G, nb in DENSE_BWD:
        out[f"dense_10_bwd_g{G}_nb{nb}"] = (
            lambda G=G, nb=nb: av.attention_v2_bwd(qkv, o, lse, dout, HEADS,
                                                   SCALE, G, nb))
    _, p = av.attention_save_p_fwd(qkv, HEADS, SCALE, 2, 208)
    out["dense_11_fwd_g2_nb208"] = (
        lambda: av.attention_save_p_fwd(qkv, HEADS, SCALE, 2, 208))
    out["dense_11_bwd_g2_nb208"] = (
        lambda: av.attention_save_p_bwd(qkv, p, dout, HEADS, SCALE, 2))
    wqkv = rand(GRID_B, GRID, GRID, 3 * C)
    wdout = rand(GRID_B, GRID, GRID, C)
    args = (HEADS, WINDOW, SCALE)
    wo, wlse = av.window_v2_fwd(wqkv, *args)
    wo4, wlse4 = wa.window_attention_fwd(wqkv, *args)
    out["window_4_fwd"] = lambda: wa.window_attention_fwd(wqkv, *args)
    out["window_sdpa_fwd"] = sdpa_call(wa.partition(wqkv, WINDOW))
    out["window_5_bwd"] = lambda: wa.window_attention_bwd(wqkv, wo4, wlse4,
                                                          wdout, *args)
    out["window_sdpa_bwd"] = sdpa_bwd_call(wa.partition(wqkv, WINDOW),
                                           wa.partition(wdout, WINDOW))
    for G in WINDOW_G:
        out[f"window_12_fwd_g{G}"] = (
            lambda G=G: av.window_v2_fwd(wqkv, *args, G))
    for G in WINDOW_G:
        out[f"window_12_bwd_g{G}"] = (
            lambda G=G: av.window_v2_bwd(wqkv, wo, wlse, wdout, *args, G))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_resident: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build()
    ms = {name: {"per_call": per_call_ms(fn),
                 "back_to_back": back_to_back_ms(fn)}
          for name, fn in cases().items()}
    print(json.dumps({"checkout": ssl4gie_tpu_torch.__file__, "card": card,
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
