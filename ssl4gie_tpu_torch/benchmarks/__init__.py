"""Kernel A/B harnesses of the port: counterparts of the JAX package's
`benchmarks/bench_attention_kernel.py` (`bench_attention_kernel` here) and
`benchmarks/bench_window_kernel.py` (`bench_window_kernel`).

Each times the value and gradient of an attention-only chain of L layers,
x <- x + cat([o, o, o]) with o = layer(x) * 0.1, loss sum(x^2) * 1e-9 and
the update x <- x - 1e-6 * loss * grad, one leg per attention layer (the
plain head-split layer, the port's kernel, its A/B variants). They run on
the card by default (CUDA-event medians of the timed steps); `--device cpu`
runs them on the CPU, where every layer takes its plain version, as the
tests do. Nothing runs at import.

The helpers below are shared by both harnesses.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time
from typing import Callable, NamedTuple

import torch


class Leg(NamedTuple):
    """One leg of a harness: its printed label; its layer (x -> out, through
    autograd); the kernels one layer launches once each, as (wrapper,
    configuration) pairs (configuration None for a production kernel,
    whose launches its own path counts); the plain versions of those
    kernels as one function (x, dout) -> (out, dx) on any device; and the
    layer that its parity leg checks against the current kernel first."""
    label: str
    layer: Callable
    kernels: tuple = ()
    plain: Callable | None = None
    parity: Callable | None = None


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def resolve_device(device: str | None = None) -> torch.device:
    """The card unless `device` names another; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the harness times the card "
                               "(pass --device cpu to run it on the CPU)")
        return torch.device("cuda")
    return torch.device(device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU's name."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def chain_loss_and_grad(layer: Callable, x: torch.Tensor, L: int):
    """loss = sum(y^2) * 1e-9 (in float32) after L layers y <- y +
    cat([o, o, o]) with o = layer(y) * 0.1 in x's dtype, and its gradient
    in x."""
    x = x.detach().requires_grad_(True)
    y = x
    for _ in range(L):
        o = layer(y) * 0.1
        y = y + torch.cat([o, o, o], dim=-1)
    loss = torch.sum(y.float() ** 2) * 1e-9
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


def chain_step(layer: Callable, x: torch.Tensor, L: int):
    """One step: x - 1e-6 * loss * grad (the update depends on the
    gradient), and the loss."""
    v, g = chain_loss_and_grad(layer, x, L)
    return x - ((1e-6 * v) * g.float()).to(x.dtype), v


def bench_chain(layer: Callable, name: str, x0: torch.Tensor, L: int,
                steps: int, flops: float, card: str,
                what: str = "attn layers", warmup: int = 1) -> dict:
    """`warmup` steps, then `steps` timed steps of the chain: the median
    step time (CUDA events per step on the card, the host clock on the
    CPU), the rate of `flops` useful operations per step, the losses.
    Prints one line with the card."""
    cuda = x0.device.type == "cuda"
    x, losses, times = x0, [], []
    for i in range(warmup + steps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        x, v = chain_step(layer, x, L)
        losses.append(v)
        if cuda:
            end.record()
            if i >= warmup:
                times.append((start, end))
        elif i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    if cuda:
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in times]
    ms = statistics.median(times)
    rate = flops / (ms / 1e3) / 1e12
    print(f"{name}: {ms:.3f} ms/step (median of {steps}; {L} {what} "
          f"fwd+bwd, B={x0.shape[0]}) -> {rate:.2f} TFLOP/s effective  "
          f"[{card}]", flush=True)
    return {"name": name, "ms_step": ms, "ms_steps": times,
            "tflops": rate, "losses": [float(v) for v in losses],
            "steps_run": warmup + steps}


def parity(ref: Callable, layer: Callable, small: torch.Tensor):
    """Max |difference| of a variant's forward and gradient (cotangent
    ones) against the current kernel's on `small`."""
    def fwd_grad(fn):
        x = small.detach().requires_grad_(True)
        out = fn(x)
        (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
        return out.detach().float(), g.float()

    f0, g0 = fwd_grad(ref)
    f2, g2 = fwd_grad(layer)
    return ((f0 - f2).abs().max().item(), (g0 - g2).abs().max().item())
