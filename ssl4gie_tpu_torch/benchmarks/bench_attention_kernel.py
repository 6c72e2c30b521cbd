"""Dense-attention kernel A/B harness on the card: the port's packed-QKV
kernels (#1/#2 and the variants #10 and #11) against a plain head-split
layer. Counterpart of the JAX package's `benchmarks/bench_attention_kernel.py`,
with the same legs, chain, loss, update and sizes.

ViT-B 224 shapes: B = 128 images, N = 197 tokens, H = 12 heads of Dh = 64,
bf16, packed (B, N, 3C) qkv; the value and gradient of a chain of L = 12
attention layers (the attention of a ViT-B train step). Effective TFLOP/s
counts the useful products at the real N: 2 forward and 5 backward products
of 2 N^2 Dh a head.

    python -m ssl4gie_tpu_torch.benchmarks.bench_attention_kernel \\
        [xla|fused|v2|v2g4|v3|v2g44|v3g44|v4|both] [--device cpu]

Legs: `xla` the head-split layer with a materialised softmax (torch ops);
`fused` the port's #1/#2 (`kernels/dense_attention.py`); `v2` #10 with G
images a block forward / backward and Nb-row score tiles: `v2` G 2/2 Nb 256,
`v2g4` 4/2, `v3` 2/2 Nb 208, `v2g44` 4/4, `v3g44` 4/4 Nb 208; `v4` #11
save-P, G 2/2, Nb 208 (`kernels/attention_variants.py`); `both` runs xla,
fused and v2. Before a variant the parity leg (unless ATTN_CHECK=0) prints
its forward's and gradient's largest difference from `fused` on 8 images.
Sizes from ATTN_BENCH_B (128), ATTN_BENCH_L (12), ATTN_BENCH_STEPS (10).
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from ssl4gie_tpu_torch.benchmarks import (Leg, bench_chain, card_line,
                                          env_int, parity, resolve_device)
from ssl4gie_tpu_torch.kernels import attention_variants as av
from ssl4gie_tpu_torch.kernels import dense_attention as da

N, H, Dh = 197, 12, 64
C = H * Dh
SCALE = Dh ** -0.5
DTYPE = torch.bfloat16
CHECK_B = 8


def sizes() -> tuple[int, int, int]:
    """(B, L, STEPS) from the environment, as the JAX harness reads them."""
    return (env_int("ATTN_BENCH_B", 128), env_int("ATTN_BENCH_L", 12),
            env_int("ATTN_BENCH_STEPS", 10))


def make_x0(B: int, device: torch.device) -> torch.Tensor:
    """The JAX harness's input: normal(0, 1) from numpy seed 0, in bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, N, 3 * C)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=DTYPE)


def xla_layer(qkv: torch.Tensor) -> torch.Tensor:
    """The plain layer: split heads, materialised softmax in float32,
    merge heads."""
    B = qkv.shape[0]
    q, k, v = (t.reshape(B, N, H, Dh).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    s = (q @ k.transpose(-2, -1)).float() * SCALE
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return (p @ v).transpose(1, 2).reshape(B, N, C)


def fused_layer(qkv: torch.Tensor) -> torch.Tensor:
    return da.fused_qkv_attention(qkv, H, SCALE)


def v2_layer(fwd_G: int, bwd_G: int, Nb: int = 256):
    return functools.partial(av.packed_attention_v2, num_heads=H, scale=SCALE,
                             fwd_G=fwd_G, bwd_G=bwd_G, Nb=Nb)


def v4_layer(fwd_G: int = 2, bwd_G: int = 2, Nb: int = 208):
    return functools.partial(av.packed_attention_save_p, num_heads=H,
                             scale=SCALE, fwd_G=fwd_G, bwd_G=bwd_G, Nb=Nb)


def fused_plain(x: torch.Tensor, dout: torch.Tensor):
    """#1/#2's plain versions: one layer's output and gradient."""
    return (da.fused_qkv_attention_plain(x, H, SCALE),
            da.fused_qkv_attention_bwd_plain(x, dout, H, SCALE))


def v2_plain(x: torch.Tensor, dout: torch.Tensor):
    """#10's plain versions: one layer's output and gradient."""
    return (av.packed_attention_v2_fwd_plain(x, H, SCALE)[0],
            av.packed_attention_v2_bwd_plain(x, dout, H, SCALE))


def v4_plain(x: torch.Tensor, dout: torch.Tensor, Nb: int = 208):
    """#11's plain versions: one layer's output and gradient (through the
    saved P)."""
    out, p = av.packed_attention_save_p_fwd_plain(x, H, SCALE, Nb)
    return out, av.packed_attention_save_p_bwd_plain(x, p, dout, H, SCALE)


def v2_leg(label: str, fwd_G: int, bwd_G: int, Nb: int = 256,
           parity=None) -> Leg:
    return Leg(label, v2_layer(fwd_G, bwd_G, Nb),
               ((av.attention_v2_fwd, (fwd_G, Nb)),
                (av.attention_v2_bwd, (bwd_G, Nb))), v2_plain, parity)


def v4_leg(label: str, fwd_G: int = 2, bwd_G: int = 2, Nb: int = 208,
           parity=None) -> Leg:
    return Leg(label, v4_layer(fwd_G, bwd_G, Nb),
               ((av.attention_save_p_fwd, (fwd_G, Nb)),
                (av.attention_save_p_bwd, (bwd_G, Nb))),
               functools.partial(v4_plain, Nb=Nb), parity)


LEGS = {
    "xla": Leg("head-split + softmax    ", xla_layer),
    "fused": Leg("fused dense #1/#2       ", fused_layer,
                 ((da.attention_fwd, None), (da.attention_bwd, None)),
                 fused_plain),
    "v2": v2_leg("v2 G2/2 Nb 256          ", 2, 2, parity=v2_layer(2, 2)),
    "v2g4": v2_leg("v2 G4/2 Nb 256          ", 4, 2, parity=v2_layer(2, 2)),
    "v3": v2_leg("v3 G2/2 Nb 208          ", 2, 2, 208,
                 parity=v2_layer(2, 2, 208)),
    "v2g44": v2_leg("v2 G4/4 Nb 256          ", 4, 4),
    "v3g44": v2_leg("v3 G4/4 Nb 208          ", 4, 4, 208,
                    parity=v2_layer(4, 4, 208)),
    "v4": v4_leg("v4 save-P G2/2 Nb 208   ", parity=v4_layer()),
}
CLI = {"both": ("xla", "fused", "v2"), **{leg: (leg,) for leg in LEGS}}


def attn_flops(B: int, L: int) -> float:
    """Useful products of a step at the real N: 7 of 2 N^2 Dh a head."""
    return 7 * 2 * N * N * Dh * H * B * L


def check_v2(layer, x0: torch.Tensor, card: str):
    """The variant's forward and gradient against `fused` on the first
    CHECK_B images: the largest absolute differences."""
    err_f, err_g = parity(fused_layer, layer, x0[:CHECK_B])
    print(f"variant parity vs current: fwd max|d|={err_f:.3e} "
          f"bwd max|d|={err_g:.3e}  [{card}]", flush=True)
    return err_f, err_g


def bench(leg: str, x0: torch.Tensor, L: int, steps: int, card: str,
          warmup: int = 1) -> dict:
    """One leg's chain, timed."""
    return bench_chain(LEGS[leg].layer, LEGS[leg].label, x0, L, steps,
                       attn_flops(x0.shape[0], L), card, warmup=warmup)


def run(which: str = "both", device: str | None = None,
        check: bool | None = None) -> dict:
    """The legs that `which` names, at the environment's sizes: {leg: the
    result of bench_chain}, with each variant's parity under "check"."""
    dev = resolve_device(device)
    card = card_line(dev)
    B, L, steps = sizes()
    if check is None:
        check = os.environ.get("ATTN_CHECK", "1") == "1"
    x0 = make_x0(B, dev)
    results = {}
    for leg in CLI[which]:
        variant = LEGS[leg].parity
        if check and variant is not None:
            results.setdefault("check", {})[leg] = check_v2(variant, x0, card)
        results[leg] = bench(leg, x0, L, steps, card)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="?", default="both", choices=list(CLI))
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' runs the plain "
                             "versions on the CPU")
    args = parser.parse_args(argv)
    run(args.which, args.device)


if __name__ == "__main__":
    main()
