#!/usr/bin/env python3
"""Drive the PyTorch port (`ssl4gie_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `ssl4gie_tpu_torch/csrc/` (first use).
2. Kernel phase: each kernel against its plain PyTorch version on the card at
   its path's shapes, with both times (CUDA events, median of runs):
   - classification: B=64 images, ViT-B/16 attention N=197 H=12 Dh=64,
     224x224x3 rotation;
   - detection: windowed attention on a (4, 64, 64, 3*768) grid with 16x16
     windows, flash attention at (48, 4096, 64), and a masked flash case
     (N=1024, n_valid=1000).
3. Classification path: the ViT-B/16 224 px finetune step at full width
   (uint8 batch -> on-device augmentation -> forward/backward -> AdamW), a few
   steps from random weights made from a seed. The kernels' launch counters
   must grow by exactly 12 attention forwards, 12 attention backwards and one
   rotation per step; the losses must be finite; the model's logits must agree
   with a float32 CPU run of the same weights on a small input.
4. Detection path: the ViT-B Faster R-CNN train step at full width, 1024 px,
   B=4 (uint8 batch -> on-device `detection_augment` -> forward/backward of
   the four losses -> AdamW), a few steps. The counters must grow by exactly
   8 window forwards, 8 window backwards, 4 flash forwards and 4 flash
   backwards per step; the losses must be finite; one eval forward must give
   detections of the expected shapes; the backbone's map must agree with a
   float32 CPU run of the same weights on a small (512 px) input.
5. Prints one JSON line of per-kernel results, then the last line
   `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

    python3 chip_smoke.py --profile DIR

also profiles a few detection steps with `torch.profiler` (device time by
kernel, the device's busy share, the NMS slot loop's host time) and writes
the table to DIR.

Any failure raises (nonzero exit, no result). There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.data.augment import (eval_batch, normalize,
                                            rotation_factors)
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.kernels import window_attention as wa
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.tasks.detection import (SyntheticDetectionSource,
                                               make_detection_full_step)

SEED = 0
B = 64                  # main-path batch (images per step)
IMG = 224
HEADS, HEAD_DIM, TOKENS = 12, 64, 197
NUM_CLASSES = 6
WARMUP_STEPS, TIMED_STEPS = 2, 5
LR = 1e-4
LOGIT_TOL = 0.05    # bf16 compute vs f32: 5% of the largest logit
DET_B, DET_IMG, DET_GRID, DET_WINDOW = 4, 1024, 64, 16   # bench.py's batch
DET_BH, DET_N = DET_B * HEADS, DET_GRID * DET_GRID       # global attention
DET_WARMUP_STEPS, DET_TIMED_STEPS = 1, 3
DET_REF_IMG = 512   # f32 CPU reference: 32x32 grid, 4 windows, N=1024 global


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


def det_kernel_phase(card: str) -> list[dict]:
    """The window and flash kernels against their plain versions at the
    detection path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    C = HEADS * HEAD_DIM
    scale = HEAD_DIM ** -0.5
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    tol = 2.0 ** -6          # two bf16 ulps, as the dense kernel
    results = []

    qkv = rand(DET_B, DET_GRID, DET_GRID, 3 * C)
    dout = rand(DET_B, DET_GRID, DET_GRID, C)
    args = (HEADS, DET_WINDOW, scale)
    out_k, lse_k = wa.window_attention_fwd(qkv, *args)
    torch.cuda.synchronize()
    out_p, lse_p = wa.windowed_attention_fwd_plain(qkv, *args)
    err = check_close("window_attention_fwd", out_k, out_p, tol)
    check_close("window_attention_fwd lse", lse_k, lse_p, 2.0 ** -16)
    ms = cuda_ms(lambda: wa.window_attention_fwd(qkv, *args))
    plain_ms = cuda_ms(lambda: wa.windowed_attention_fwd_plain(qkv, *args))
    results.append({"name": "window_attention_fwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/window_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/window_attention.py:93",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] window fwd  B={DET_B} grid {DET_GRID}x{DET_GRID} "
          f"window {DET_WINDOW} H={HEADS} Dh={HEAD_DIM} bf16: "
          f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms  [{card}]", flush=True)

    dq_k = wa.window_attention_bwd(qkv, out_k, lse_k, dout, *args)
    torch.cuda.synchronize()
    err = check_close("window_attention_bwd", dq_k,
                      wa.windowed_attention_bwd_plain(qkv, dout, *args), tol)
    ms = cuda_ms(lambda: wa.window_attention_bwd(qkv, out_k, lse_k, dout,
                                                 *args))
    x = qkv.detach().requires_grad_(True)
    o = wa.windowed_attention_plain(x, *args)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(o, x, dout,
                                                   retain_graph=True))
    del x, o
    results.append({"name": "window_attention_bwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/window_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/window_attention.py:120",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] window bwd  same shapes: max|err|={err:.3g} (tol "
          f"{tol:.3g} rel) kernel {ms:.4f} ms, plain (autograd) "
          f"{plain_ms:.4f} ms  [{card}]", flush=True)
    del qkv, dout, out_k, lse_k, out_p, lse_p, dq_k

    q, k, v, do = (rand(DET_BH, DET_N, HEAD_DIM) for _ in range(4))
    o_k, lse_k = fa.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale)
    err = check_close("flash_fwd", o_k, o_p, tol)
    check_close("flash_fwd lse", lse_k, lse_p, 2.0 ** -16)
    del o_p, lse_p
    ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, scale))
    results.append({"name": "flash_attention_fwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/flash_attention.py:136",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] flash fwd   BH={DET_BH} N={DET_N} D={HEAD_DIM} bf16: "
          f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms  [{card}]", flush=True)

    grads_k = fa.flash_bwd(q, k, v, o_k, lse_k, do, scale)
    torch.cuda.synchronize()
    grads_p = fa.flash_attention_bwd_plain(q, k, v, do, scale)
    err = max(check_close(f"flash_bwd d{n}", g, r, tol)
              for n, g, r in zip("qkv", grads_k, grads_p))
    del grads_k, grads_p
    ms = cuda_ms(lambda: fa.flash_bwd(q, k, v, o_k, lse_k, do, scale))
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention_plain(*xs, scale)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(o, xs, do,
                                                   retain_graph=True))
    del xs, o
    results.append({"name": "flash_attention_bwd", "route": "cuda",
                    "source": "ssl4gie_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "ssl4gie_tpu/kernels/flash_attention.py:173",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernel] flash bwd   same shapes: max|err|={err:.3g} (tol "
          f"{tol:.3g} rel) kernel {ms:.4f} ms, plain (autograd) "
          f"{plain_ms:.4f} ms  [{card}]", flush=True)
    del q, k, v, do, o_k, lse_k

    # masked keys: N = 1024 with n_valid = 1000
    q, k, v, do = (rand(DET_BH, 1024, HEAD_DIM) for _ in range(4))
    o_k, lse_k = fa.flash_fwd(q, k, v, scale, 1000)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, 1000)
    err = check_close("flash_fwd masked", o_k, o_p, tol)
    check_close("flash_fwd masked lse", lse_k, lse_p, 2.0 ** -16)
    grads_k = fa.flash_bwd(q, k, v, o_k, lse_k, do, scale, 1000)
    torch.cuda.synchronize()
    grads_p = fa.flash_attention_bwd_plain(q, k, v, do, scale, 1000)
    err = max([err] + [check_close(f"flash_bwd masked d{n}", g, r, tol)
                       for n, g, r in zip("qkv", grads_k, grads_p)])
    print(f"[kernel] flash masked BH={DET_BH} N=1024 n_valid=1000: fwd and "
          f"bwd max|err|={err:.3g} (tol {tol:.3g} rel)  [{card}]", flush=True)
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


DET_COUNTERS = {"window_attention_fwd": wa.window_attention_fwd,
                "window_attention_bwd": wa.window_attention_bwd,
                "flash_attention_fwd": fa.flash_fwd,
                "flash_attention_bwd": fa.flash_bwd}


def det_setup():
    """The full-width detector (random weights from SEED), its optimizer,
    the full step, a synthetic uint8 batch on the card and a generator."""
    dev = torch.device("cuda")
    model = FasterRCNN(image_size=DET_IMG, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED),
                       device=dev)
    src = SyntheticDetectionSource(DET_B, canvas=DET_IMG, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in src.batch(range(DET_B)).items()}
    return (model, make_adamw(model.parameters(), LR),
            make_detection_full_step(), batch,
            torch.Generator(device=dev).manual_seed(SEED))


def det_path(card: str) -> dict:
    """The full-width ViT-B Faster R-CNN train step at 1024 px, a few times;
    returns the launch counts."""
    dev = torch.device("cuda")
    model, optimizer, full_step, batch, gen = det_setup()
    n_windowed = sum(b.attn.window_size is not None
                     for b in model.backbone.blocks)
    n_global = len(model.backbone.blocks) - n_windowed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in DET_COUNTERS.values():
        fn.launches = 0
    losses = []
    n_steps = DET_WARMUP_STEPS + DET_TIMED_STEPS
    for step in range(n_steps):
        if step == DET_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(full_step(model, optimizer, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in DET_COUNTERS.items()}
    expected = {"window_attention_fwd": n_windowed * n_steps,
                "window_attention_bwd": n_windowed * n_steps,
                "flash_attention_fwd": n_global * n_steps,
                "flash_attention_bwd": n_global * n_steps}
    print(f"[det] launches over {n_steps} steps: {launches} "
          f"(expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError("the detection path did not run through the "
                             f"kernels as expected: {launches} != {expected}")
    losses = [{k: float(v) for k, v in d.items()} for d in losses]
    print(f"[det] losses: {losses}", flush=True)
    if not all(np.isfinite(list(d.values())).all() for d in losses):
        raise AssertionError(f"non-finite detection loss: {losses}")
    ms_step = dt / DET_TIMED_STEPS * 1e3
    print(f"[det] ViT-B Faster R-CNN {DET_IMG} px train step, B={DET_B}, bf16 "
          f"compute / f32 AdamW, detection_augment on device: "
          f"{ms_step:.2f} ms/step, {DET_B * DET_TIMED_STEPS / dt:.2f} img/s "
          f"(mean of {DET_TIMED_STEPS} steps after {DET_WARMUP_STEPS} "
          f"warm-up), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
          flush=True)

    model.eval()
    with torch.no_grad():
        det = model(batch["image"].to(torch.float32) / 255.0)
    torch.cuda.synchronize()
    D = model.detections_per_img
    shapes = {k: tuple(v.shape) for k, v in det.items()}
    want = {"boxes": (DET_B, D, 4), "scores": (DET_B, D),
            "labels": (DET_B, D), "valid": (DET_B, D)}
    print(f"[det] eval detections: {shapes}, valid per image "
          f"{det['valid'].sum(1).tolist()}", flush=True)
    if shapes != want or not bool(torch.isfinite(det["boxes"]).all()):
        raise AssertionError(f"bad detections: {shapes} (want {want})")

    # the card's bf16 kernel path against a float32 CPU run of the same
    # weights (plain attention) on a small input: the backbone map at 512 px
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    small = FasterRCNN(image_size=DET_REF_IMG, dtype=torch.bfloat16)
    small.load_state_dict(sd)
    ref_model = FasterRCNN(image_size=DET_REF_IMG, dtype=torch.float32)
    ref_model.load_state_dict(sd)
    x = normalize(batch["image"][:1, :DET_REF_IMG, :DET_REF_IMG]
                  .to(torch.float32) / 255.0)
    small.to(dev).eval()
    with torch.no_grad():
        fmap = small.backbone(x.to(torch.bfloat16)).float().cpu()
        ref = ref_model.eval().backbone(x.cpu())
    err = (fmap - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[det] backbone map ({DET_REF_IMG} px) bf16 on card vs f32 on "
          f"CPU: max|err|={err:.4g}, max|ref|={scale:.4g}", flush=True)
    if not bool(torch.isfinite(fmap).all()) or err > LOGIT_TOL * scale:
        raise AssertionError(f"backbone maps disagree: {err} > {LOGIT_TOL} "
                             f"* {scale}")
    return launches


def profile_det(card: str, out_dir: str) -> None:
    """torch.profiler over DET_TIMED_STEPS detection steps after one warm-up:
    device time by kernel, the device's busy share, and the NMS slot loop's
    host time ("nms_topk" range); the table goes to out_dir."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssl4gie_tpu_torch.ops.nms import nms_topk
    model, optimizer, full_step, batch, gen = det_setup()
    full_step(model, optimizer, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DET_TIMED_STEPS):
            full_step(model, optimizer, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / DET_TIMED_STEPS * 1e3
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    Path(out_dir, "det_profile.txt").write_text(
        f"{card}\nwall {wall:.2f} ms/step over {DET_TIMED_STEPS} steps "
        f"under the profiler\n{table}\n")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / \
        DET_TIMED_STEPS
    # the "nms_topk" range on the device timeline: first to last kernel of
    # the slot loop, idle gaps included
    nms = [e for e in events if e.key == "nms_topk"]
    nms_ms = max((e.device_time_total for e in nms), default=0) / 1e3 / \
        DET_TIMED_STEPS
    print(f"[profile] detection step under the profiler: wall {wall:.2f} "
          f"ms/step, device kernels {dev_ms:.2f} ms/step (busy share "
          f"{dev_ms / wall:.3f}); nms_topk span {nms_ms:.2f} ms/step "
          f"({nms_ms / wall:.3f} of wall)  [{card}]", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / DET_TIMED_STEPS:9.3f} "
              f"ms/step  x{e.count // DET_TIMED_STEPS:<6d} {e.key[:90]}")
    # the RPN's slot loop alone, without the profiler: B images of 8768
    # candidates (2000 per level, 768 at stride 64), 1000 slots
    n = 4 * model.rpn_pre_nms_top_n[0] + (DET_IMG // 64) ** 2 * 3
    xy = torch.rand((DET_B, n, 2), device="cuda") * DET_IMG
    boxes = torch.cat([xy, xy + 8 + torch.rand_like(xy) * 200], dim=-1)
    scores = torch.rand((DET_B, n), device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nms_topk(boxes, scores, 0.7, model.rpn_post_nms_top_n[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] RPN slot loop alone (B={DET_B}, {n} candidates, "
          f"{model.rpn_post_nms_top_n[0]} slots), no profiler: "
          f"{statistics.median(times):.2f} ms (median of 3)  [{card}]",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile the detection step; the table "
                             "goes to DIR")
    args = parser.parse_args()
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

    phases = [("kernels (classification shapes)", kernel_phase),
              ("kernels (detection shapes)", det_kernel_phase),
              ("classification path", main_path),
              ("detection path", det_path)]
    results, launches = [], {}
    for name, phase in phases:
        t0 = time.perf_counter()
        out = phase(card)
        if isinstance(out, list):
            results += out
        else:
            launches.update(out)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s wall",
              flush=True)
    for r in results:
        r["launches"] = launches[r["name"]]
    if args.profile:
        profile_det(card, args.profile)
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
