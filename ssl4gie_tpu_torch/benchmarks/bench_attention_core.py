"""Times the streaming attention core's kernels on the card at their paths'
shapes: #1/#2 (dense, B=64 N=197 H=12 Dh=64; the MAE decoder's B=256 H=16
Dh=32), #4/#5 (windows of 16 x 16 on a (4, 64, 64, 3*768) grid) and #6/#7
(flash, (48, 4096, 64)), forward and backward in bf16, and in float32 the
same plus #1/#2 at the MAE ViT-H's B=64 N=180 H=16 Dh=80 and the forward
#6 at the eval batch's (24, 4096, 64), each per call (median of 20
CUDA-event readings) and back to back (20 calls between two events).
Prints one JSON line with the card's name and power limit.

It imports only the kernel modules, which every checkout of the port has,
so that two checkouts can be compared in one call on one card:

    PYTHONPATH=<checkout> python3 <this file>

times the kernels of the `ssl4gie_tpu_torch` under <checkout>.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

import ssl4gie_tpu_torch
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import window_attention as wa

RUNS = 20


def per_call_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / RUNS


def cases():
    """name -> {"fwd": call, "bwd": call} on seeded inputs, in bf16 and in
    float32 (`_f32`, with the Dh-80 shape and the flash eval forward)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        rand = lambda *shape: torch.randn(shape, generator=gen,
                                          device="cuda").to(dt)
        dense = [("dense_dh64", (64, 197, 12, 64)),
                 ("dense_dh32", (256, 197, 16, 32))]
        if sfx:
            dense.append(("dense_dh80", (64, 180, 16, 80)))
        calls = {}
        for name, (b, n, heads, dh) in dense:
            qkv, dout = rand(b, n, 3 * heads * dh), rand(b, n, heads * dh)
            scale = dh ** -0.5
            o, lse = da.attention_fwd(qkv, heads, scale)
            calls[name] = (
                lambda qkv=qkv, heads=heads, scale=scale:
                    da.attention_fwd(qkv, heads, scale),
                lambda qkv=qkv, o=o, lse=lse, dout=dout, heads=heads,
                scale=scale: da.attention_bwd(qkv, o, lse, dout, heads,
                                              scale))
        args = (12, 16, 64 ** -0.5)
        qkv, dout = rand(4, 64, 64, 3 * 768), rand(4, 64, 64, 768)
        o, lse = wa.window_attention_fwd(qkv, *args)
        calls["window"] = (
            lambda qkv=qkv: wa.window_attention_fwd(qkv, *args),
            lambda qkv=qkv, o=o, lse=lse, dout=dout:
                wa.window_attention_bwd(qkv, o, lse, dout, *args))
        q, k, v, do = (rand(48, 4096, 64) for _ in range(4))
        fo, flse = fa.flash_fwd(q, k, v, 64 ** -0.5)
        calls["flash"] = (
            lambda q=q, k=k, v=v: fa.flash_fwd(q, k, v, 64 ** -0.5),
            lambda q=q, k=k, v=v, fo=fo, flse=flse, do=do:
                fa.flash_bwd(q, k, v, fo, flse, do, 64 ** -0.5))
        for name, (fwd, bwd) in calls.items():
            out[name + sfx] = {"fwd": fwd, "bwd": bwd}
        if sfx:
            q, k, v = (rand(24, 4096, 64) for _ in range(3))
            out["flash_eval" + sfx] = {
                "fwd": lambda q=q, k=k, v=v: fa.flash_fwd(q, k, v,
                                                          64 ** -0.5)}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_core: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build()
    ms = {}
    for name, calls in cases().items():
        for side, fn in calls.items():
            ms[f"{name}_{side}"] = {"per_call": per_call_ms(fn),
                                    "back_to_back": back_to_back_ms(fn)}
    print(json.dumps({"checkout": ssl4gie_tpu_torch.__file__, "card": card,
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
