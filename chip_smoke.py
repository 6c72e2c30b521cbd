#!/usr/bin/env python3
"""Drive the PyTorch port (`ssl4gie_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `ssl4gie_tpu_torch/csrc/` (first use).
2. Kernel phase: each kernel against its plain PyTorch version on the card at
   the main path's shapes (B=64 images, ViT-B/16 attention N=197 H=12 Dh=64,
   224x224x3 rotation), with both times (CUDA events, median of runs).
3. Main path: the ViT-B/16 224 px classification finetune step at full width
   (uint8 batch -> on-device augmentation -> forward/backward -> AdamW), a few
   steps from random weights made from a seed. The kernels' launch counters
   must grow by exactly 12 attention forwards, 12 attention backwards and one
   rotation per step; the losses must be finite; the model's logits must agree
   with a float32 CPU run of the same weights on a small input.
4. Prints one JSON line of per-kernel results, then the last line
   `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Any failure raises (nonzero exit, no result). There is no CPU fallback.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.data.augment import eval_batch, rotation_factors
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models.vit import ViTClassifier

SEED = 0
B = 64                  # main-path batch (images per step)
IMG = 224
HEADS, HEAD_DIM, TOKENS = 12, 64, 197
NUM_CLASSES = 6
WARMUP_STEPS, TIMED_STEPS = 2, 5
LR = 1e-4
LOGIT_TOL = 0.05    # bf16 compute vs f32: 5% of the largest logit


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of `fn` over `runs`, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def check_close(name, got, ref, rel_tol: float) -> float:
    """Max |got - ref|; raise unless every element is finite and within
    rel_tol * (|ref| + max|ref|)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bound = rel_tol * (ref.abs() + ref.abs().max())
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: kernel disagrees with the plain version:"
                             f" max|err|={err.max().item():.4g}, "
                             f"max|ref|={ref.abs().max().item():.4g}")
    return err.max().item()


def kernel_phase(card: str) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    C = HEADS * HEAD_DIM
    scale = HEAD_DIM ** -0.5
    qkv = torch.randn((B, TOKENS, 3 * C), generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn((B, TOKENS, C), generator=gen, device=dev).to(
        torch.bfloat16)
    results = []

    # bf16 output and two bf16 roundings of f32 sums: two bf16 ulps (2^-6)
    # of the element or of the largest element, whichever is larger
    tol = 2.0 ** -6
    out_k, lse_k = da.attention_fwd(qkv, HEADS, scale)
    torch.cuda.synchronize()
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, HEADS, scale)
    err = check_close("attention_fwd", out_k, out_p, tol)
    # f32 log-sum-exp of f32 sums of bf16 products: 2^-16 relative
    check_close("attention_fwd lse", lse_k, lse_p, 2.0 ** -16)
    ms = cuda_ms(lambda: da.attention_fwd(qkv, HEADS, scale))
    plain_ms = cuda_ms(lambda: da.fused_qkv_attention_plain(qkv, HEADS, scale))
    results.append({"name": "dense_attention_fwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/dense_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/dense_attention.py:64",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] attention fwd  B={B} N={TOKENS} H={HEADS} Dh={HEAD_DIM} "
          f"bf16: max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms  [{card}]", flush=True)

    dq_k = da.attention_bwd(qkv, out_k, lse_k, dout, HEADS, scale)
    torch.cuda.synchronize()
    dq_p = da.fused_qkv_attention_bwd_plain(qkv, dout, HEADS, scale)
    err = check_close("attention_bwd", dq_k, dq_p, tol)
    ms = cuda_ms(lambda: da.attention_bwd(qkv, out_k, lse_k, dout, HEADS,
                                          scale))
    x = qkv.detach().requires_grad_(True)
    o = da.fused_qkv_attention_plain(x, HEADS, scale)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(o, x, dout,
                                                   retain_graph=True))
    results.append({"name": "dense_attention_bwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/dense_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/dense_attention.py:90",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] attention bwd  same shapes: max|err|={err:.3g} "
          f"(tol {tol:.3g} rel) kernel {ms:.4f} ms, plain (autograd) "
          f"{plain_ms:.4f} ms  [{card}]", flush=True)

    img = (torch.randint(0, 256, (B, IMG, IMG, 3), generator=gen, device=dev)
           .to(torch.bfloat16) / 255.0).contiguous()
    angle = (torch.rand((B,), generator=gen, device=dev) * 360.0) - 180.0
    q, alpha, beta = rotation_factors(angle)
    r_k = rot.shear_rotate(img, alpha, beta, 0.0, quarter=q)
    torch.cuda.synchronize()
    r_p = rot.shear_rotate_plain(img, alpha, beta, 0.0, quarter=q)
    if not torch.equal(r_k, r_p):
        n_bad = int((r_k != r_p).sum())
        raise AssertionError(f"shear_rotate: {n_bad} elements differ from the "
                             "plain version (must be element-exact)")
    err = (r_k.float() - r_p.float()).abs().max().item()
    ms = cuda_ms(lambda: rot.shear_rotate(img, alpha, beta, 0.0, quarter=q))
    plain_ms = cuda_ms(lambda: rot.shear_rotate_plain(img, alpha, beta, 0.0,
                                                      quarter=q))
    results.append({"name": "shear_rotate", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/rotate.cu",
                    "replaces": "ssl4gie_tpu/kernels/rotate.py:33",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] shear rotate   B={B} {IMG}x{IMG}x3 bf16 (rot90 fold in "
          f"the kernel): element-exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms  [{card}]", flush=True)
    return results


def main_path(card: str) -> dict:
    """The full-width finetune step, a few times; returns the launch counts."""
    dev = torch.device("cuda")
    model = ViTClassifier(NUM_CLASSES, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED),
                          device=dev)
    depth = len(model.backbone.blocks)
    optimizer = make_adamw(model.parameters(), LR)
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label", loss_fn=weighted_cross_entropy)
    full_step = make_full_step(task)
    rng = np.random.default_rng(SEED)
    img_u8 = torch.from_numpy(
        rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=B)).to(dev)
    aug_gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    da.attention_fwd.launches = 0
    da.attention_bwd.launches = 0
    rot.shear_rotate.launches = 0
    losses = []
    n_steps = WARMUP_STEPS + TIMED_STEPS
    for step in range(n_steps):
        if step == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(full_step(model, optimizer, img_u8, labels,
                                aug_gen)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"dense_attention_fwd": da.attention_fwd.launches,
                "dense_attention_bwd": da.attention_bwd.launches,
                "shear_rotate": rot.shear_rotate.launches}
    expected = {"dense_attention_fwd": depth * n_steps,
                "dense_attention_bwd": depth * n_steps,
                "shear_rotate": n_steps}
    print(f"[main] launches over {n_steps} steps: {launches} "
          f"(expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError("the main path did not run through the kernels "
                             f"as expected: {launches} != {expected}")
    losses = [float(x) for x in losses]
    print(f"[main] losses: {losses}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    ms_step = dt / TIMED_STEPS * 1e3
    print(f"[main] ViT-B/16 224 px finetune step, B={B}, bf16 compute / f32 "
          f"AdamW, aug on device: {ms_step:.2f} ms/step, "
          f"{B * TIMED_STEPS / dt:.1f} img/s (mean of {TIMED_STEPS} steps "
          f"after {WARMUP_STEPS} warm-up), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
          flush=True)

    # the card's bf16 kernel path against a float32 CPU run of the same
    # weights (plain attention) on a small input
    x = eval_batch(img_u8[:2])
    model.eval()
    with torch.no_grad():
        logits = model(x).float().cpu()
        ref_model = ViTClassifier(NUM_CLASSES, dtype=torch.float32)
        ref_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        ref = ref_model.eval()(x.cpu())
    if logits.shape != (2, NUM_CLASSES) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}: {logits}")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[main] logits bf16 on card vs f32 on CPU: max|err|={err:.4g}, "
          f"max|ref|={scale:.4g}", flush=True)
    if err > LOGIT_TOL * scale:
        raise AssertionError(f"logits disagree: {err} > {LOGIT_TOL} * {scale}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path.name}",
          flush=True)
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    results = kernel_phase(card)
    launches = main_path(card)
    for r in results:
        r["launches"] = launches[r["name"]]
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
