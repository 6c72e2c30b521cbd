"""Windowed-attention kernel A/B harness on the card: the port's window
kernels (#4/#5) against the variant #12. Counterpart of the JAX package's
`benchmarks/bench_window_kernel.py`, with the same legs, chain, loss, update
and sizes.

ViT-Det 1024 px shapes: B = 2 images, a 64 x 64 token grid, 16 x 16
windows (256 tokens), H = 12 heads of Dh = 64, bf16, packed (B, GH, GW, 3C)
qkv; the value and gradient of a chain of L = 8 windowed layers (the ViT-Det
step's windowed blocks). Effective TFLOP/s counts 7 products of 2 N^2 Dh a
head and window.

    python -m ssl4gie_tpu_torch.benchmarks.bench_window_kernel \\
        [current|v2|v2g2|v2g4|all] [--device cpu]

Legs: `current` the port's #4/#5 (`kernels/window_attention.py`); `v2` #12
with one window a block (after its parity leg: forward and gradient against
`current` on one image), `v2g2` and `v2g4` two and four adjacent windows a
block (`kernels/attention_variants.py`); `all` runs current, v2 and v2g2.
Sizes from WATTN_BENCH_B (2), WATTN_BENCH_L (8), WATTN_BENCH_STEPS (10).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ssl4gie_tpu_torch.benchmarks import (Leg, bench_chain, card_line,
                                          env_int, parity, resolve_device)
from ssl4gie_tpu_torch.kernels import attention_variants as av
from ssl4gie_tpu_torch.kernels import window_attention as wa

GH = GW = 64
WS = 16
N = WS * WS
H, Dh = 12, 64
C = H * Dh
SCALE = Dh ** -0.5
DTYPE = torch.bfloat16


def sizes() -> tuple[int, int, int]:
    """(B, L, STEPS) from the environment, as the JAX harness reads them."""
    return (env_int("WATTN_BENCH_B", 2), env_int("WATTN_BENCH_L", 8),
            env_int("WATTN_BENCH_STEPS", 10))


def make_x0(B: int, device: torch.device) -> torch.Tensor:
    """The JAX harness's input: normal(0, 1) from numpy seed 0, in bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, GH, GW, 3 * C)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=DTYPE)


def current_layer(qkv: torch.Tensor) -> torch.Tensor:
    return wa.windowed_flash_attention(qkv, H, WS, SCALE)


def v2_layer(G: int):
    return functools.partial(av.window_attention_v2, num_heads=H, window=WS,
                             scale=SCALE, G=G)


def current_plain(x: torch.Tensor, dout: torch.Tensor):
    """#4/#5's plain versions: one layer's output and gradient."""
    return (wa.windowed_attention_plain(x, H, WS, SCALE),
            wa.windowed_attention_bwd_plain(x, dout, H, WS, SCALE))


def v2_plain(x: torch.Tensor, dout: torch.Tensor):
    """#12's plain versions: one layer's output and gradient."""
    return (av.window_attention_v2_fwd_plain(x, H, WS, SCALE)[0],
            av.window_attention_v2_bwd_plain(x, dout, H, WS, SCALE))


def v2_leg(label: str, G: int, checked: bool = False) -> Leg:
    return Leg(label, v2_layer(G),
               ((av.window_v2_fwd, G), (av.window_v2_bwd, G)), v2_plain,
               v2_layer(G) if checked else None)


LEGS = {
    "current": Leg("current window kernel", current_layer,
                   ((wa.window_attention_fwd, None),
                    (wa.window_attention_bwd, None)), current_plain),
    "v2": v2_leg("v2 G1                ", 1, checked=True),
    "v2g2": v2_leg("v2 G2                ", 2),
    "v2g4": v2_leg("v2 G4                ", 4),
}
CLI = {"all": ("current", "v2", "v2g2"), **{leg: (leg,) for leg in LEGS}}


def attn_flops(B: int, L: int) -> float:
    n_win = B * (GH // WS) * (GW // WS)
    return 7 * 2 * N * N * Dh * H * n_win * L


def check(layer, x0: torch.Tensor, card: str):
    """The variant's forward and gradient against `current` on one image:
    the largest absolute differences."""
    err_f, err_g = parity(current_layer, layer, x0[:1])
    print(f"v2 parity vs current: fwd max|d|={err_f:.3e} "
          f"bwd max|d|={err_g:.3e}  [{card}]", flush=True)
    return err_f, err_g


def bench(leg: str, x0: torch.Tensor, L: int, steps: int, card: str,
          warmup: int = 1) -> dict:
    """One leg's chain, timed."""
    return bench_chain(LEGS[leg].layer, LEGS[leg].label, x0, L, steps,
                       attn_flops(x0.shape[0], L), card,
                       what="windowed layers", warmup=warmup)


def run(which: str = "all", device: str | None = None) -> dict:
    """The legs that `which` names, at the environment's sizes: {leg: the
    result of bench_chain}, with the parity under "check"."""
    dev = resolve_device(device)
    card = card_line(dev)
    B, L, steps = sizes()
    x0 = make_x0(B, dev)
    results = {}
    for leg in CLI[which]:
        if LEGS[leg].parity is not None:
            results["check"] = check(LEGS[leg].parity, x0, card)
        results[leg] = bench(leg, x0, L, steps, card)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="?", default="all", choices=list(CLI))
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' runs the plain "
                             "versions on the CPU")
    args = parser.parse_args(argv)
    run(args.which, args.device)


if __name__ == "__main__":
    main()
