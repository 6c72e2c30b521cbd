#!/usr/bin/env python3
"""Drive the PyTorch port (`ssl4gie_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `ssl4gie_tpu_torch/csrc/` (first use).
2. Kernel phases: each kernel against its plain PyTorch version on the card
   at its path's shapes, with its time, the plain version's, the one
   PyTorch call that computes the same function where there is one
   (`F.scaled_dot_product_attention` on contiguous (B, H, N, Dh) tensors;
   the head-split copies are not counted) and its bound (the larger of its
   FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s, each input read
   once and each output written once). Times are CUDA-event medians; each
   backward also prints its rate, counting the five products of the
   function (S, dP, dV, dQ, dK) as the bound does.
   - classification: B=64 images, ViT-B/16 attention N=197 H=12 Dh=64,
     224x224x3 rotation;
   - detection: windowed attention on a (4, 64, 64, 3*768) grid with 16x16
     windows, flash attention at (48, 4096, 64), and masked flash cases
     (N=1024, n_valid=1000 and 3);
   - MAE: the fused MLP forward and backward at the encoder's (12800
     tokens, 768 -> 3072) and the decoder's (50432 tokens, 512 -> 2048)
     shapes, also against the unfused cuBLAS sequence F.linear -> F.gelu
     (tanh) -> F.linear and its backward (`unfused_ms`), and the dense
     attention at Dh=32, (256, 197, 3*512), 16 heads.
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
5. MAE path: the MAE ViT-B/16 pretraining step at full width (encoder 12
   blocks, 768 wide, 12 heads; decoder 8 blocks, 512 wide, 16 heads), 224
   px, B=256 (uint8 256 px canvases -> on-device `mae_augment` -> masking
   at 0.75 -> encoder on 50 tokens -> decoder on 197 -> norm-pix loss ->
   backward -> AdamW at the warmup-cosine rate -> gradient norm), with the
   fused MLP switched on for this phase only. The counters must grow by
   exactly 20 fused-MLP forwards, 20 backwards, 8 dense-attention forwards
   and 8 backwards per step; losses and gradient norms must be finite; one
   bf16 forward with the fused MLP must give the loss of the same forward
   without it within 1%; the bf16 prediction on the card must agree with a
   float32 CPU run of the same weights on a small input (B=2).
6. Prints the card's name and power limit, one JSON line of per-kernel
   results, then the last line
   `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

    python3 chip_smoke.py --profile DIR

also profiles a few classification, detection and MAE steps with
`torch.profiler` (device time by kernel, the device's busy share, the NMS
slot loop's host time) and writes the tables to DIR.

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
from ssl4gie_tpu_torch.data.ssl_augment import mae_augment, sample_mae_params
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import fused_mlp as fm
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.kernels import window_attention as wa
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models import layers
from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.ssl.mae import MAE
from ssl4gie_tpu_torch.ssl.pretrain import (MAEPretrainConfig,
                                            SyntheticUnlabeled,
                                            make_mae_full_step,
                                            make_mae_optimizer, make_schedule)
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
MAE_B, MAE_CANVAS = 256, 256       # ROADMAP's H100 row "MAE B=256"
MAE_ENC_TOKENS = MAE_B * 50        # 49 kept patches + cls
MAE_DEC_TOKENS = MAE_B * 197
MAE_DEC_HEADS, MAE_DEC_DIM = 16, 512
MAE_WARMUP_STEPS, MAE_TIMED_STEPS = 1, 3
MAE_LOSS_TOL = 0.01     # fused vs unfused MLP forward: 1% of the loss
MAE_REF_B = 2
# the card's published peaks (H100 SXM, dense bf16 tensor cores; HBM3)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work (ms), and which of
    its operations (at PEAK_FLOPS) and its bytes (at PEAK_BYTES) bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def result(name, source, replaces, err, ms, plain_ms, library_ms, flops,
           nbytes, **extra) -> dict:
    """One kernel's entry of the JSON line (launches are added later)."""
    bound_ms, bound_by = bound(flops, nbytes)
    return {"name": name, "route": "cuda",
            "source": f"ssl4gie_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def tflops(flops: float, ms: float) -> str:
    """The rate of `flops` operations in `ms` milliseconds, as printed."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def attn_work(seqs: int, heads: int, n: int, dh: int, backward: bool):
    """FLOPs and bytes of packed-QKV attention over `seqs` sequences:
    forward 2 products (Q.K^T, P.V), backward 5 (S, dP, dV, dQ, dK) of
    2 n^2 dh each per head; bytes: forward qkv in, out and lse out;
    backward qkv, out, lse, dO in and dqkv out (bf16, lse f32)."""
    tok, c = seqs * n, heads * dh
    flops = (10 if backward else 4) * seqs * heads * n * n * dh
    lse = seqs * heads * n * 4
    if backward:
        return flops, tok * (3 * c + c + c + 3 * c) * 2 + lse
    return flops, tok * (3 * c + c) * 2 + lse


def sdpa_ms(q, k, v, scale, dout=None) -> float:
    """`F.scaled_dot_product_attention` on contiguous (B, H, N, Dh) tensors:
    the forward, or (given dout) the backward alone, as autograd of a
    recorded forward."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if dout is None:
        return cuda_ms(lambda: sdpa(q, k, v, scale=scale))
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*xs, scale=scale)
    return cuda_ms(lambda: torch.autograd.grad(o, xs, dout,
                                               retain_graph=True))


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(S, N, C) -> contiguous (S, H, N, C / H)."""
    S, N, C = x.shape
    return x.reshape(S, N, heads, C // heads).transpose(1, 2).contiguous()


def heads_of(qkv: torch.Tensor, heads: int):
    """(S, N, 3C) packed qkv -> contiguous q, k, v (S, H, N, Dh)."""
    return [split_heads(t, heads) for t in qkv.chunk(3, dim=-1)]


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
    q, k, v = heads_of(qkv, HEADS)
    lib_ms = sdpa_ms(q, k, v, scale)
    results.append(result(
        "dense_attention_fwd", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:64", err, ms, plain_ms,
        lib_ms, *attn_work(B, HEADS, TOKENS, HEAD_DIM, False)))
    print(f"[kernel] attention fwd  B={B} N={TOKENS} H={HEADS} Dh={HEAD_DIM} "
          f"bf16: max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms  [{card}]",
          flush=True)

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
    del x, o
    lib_ms = sdpa_ms(q, k, v, scale, split_heads(dout, HEADS))
    work = attn_work(B, HEADS, TOKENS, HEAD_DIM, True)
    results.append(result(
        "dense_attention_bwd", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:90", err, ms, plain_ms,
        lib_ms, *work))
    print(f"[kernel] attention bwd  same shapes: max|err|={err:.3g} "
          f"(tol {tol:.3g} rel) kernel {ms:.4f} ms ({tflops(work[0], ms)}), "
          f"plain (autograd) {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms "
          f"({tflops(work[0], lib_ms)})  [{card}]", flush=True)

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
    # no matrix products; bytes: the image in and out, 3 floats per image
    results.append(result(
        "shear_rotate", "rotate.cu", "ssl4gie_tpu/kernels/rotate.py:33", err,
        ms, plain_ms, None, 0, 2 * img.numel() * 2 + B * 3 * 4))
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
    # SDPA on the partitioned (B * nw, H, 256, 64) windows
    q, k, v = heads_of(wa.partition(qkv, DET_WINDOW), HEADS)
    lib_ms = sdpa_ms(q, k, v, scale)
    n_win = DET_B * (DET_GRID // DET_WINDOW) ** 2
    results.append(result(
        "window_attention_fwd", "window_attention.cu",
        "ssl4gie_tpu/kernels/window_attention.py:93", err, ms, plain_ms,
        lib_ms, *attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, False)))
    print(f"[kernel] window fwd  B={DET_B} grid {DET_GRID}x{DET_GRID} "
          f"window {DET_WINDOW} H={HEADS} Dh={HEAD_DIM} bf16: "
          f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms  [{card}]",
          flush=True)

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
    lib_ms = sdpa_ms(q, k, v, scale,
                     split_heads(wa.partition(dout, DET_WINDOW), HEADS))
    work = attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, True)
    results.append(result(
        "window_attention_bwd", "window_attention.cu",
        "ssl4gie_tpu/kernels/window_attention.py:120", err, ms, plain_ms,
        lib_ms, *work))
    print(f"[kernel] window bwd  same shapes: max|err|={err:.3g} (tol "
          f"{tol:.3g} rel) kernel {ms:.4f} ms ({tflops(work[0], ms)}), plain "
          f"(autograd) {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms "
          f"({tflops(work[0], lib_ms)})  [{card}]", flush=True)
    del qkv, dout, out_k, lse_k, out_p, lse_p, dq_k, q, k, v

    q, k, v, do = (rand(DET_BH, DET_N, HEAD_DIM) for _ in range(4))
    o_k, lse_k = fa.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale)
    err = check_close("flash_fwd", o_k, o_p, tol)
    check_close("flash_fwd lse", lse_k, lse_p, 2.0 ** -16)
    del o_p, lse_p
    ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, scale))
    # (BH, N, D) is already contiguous (B, H, N, D)
    bhnd = lambda t: t.view(DET_B, HEADS, DET_N, HEAD_DIM)
    lib_ms = sdpa_ms(bhnd(q), bhnd(k), bhnd(v), scale)
    flash_bytes = lambda n_in, n_out: ((n_in + n_out) * DET_BH * DET_N
                                       * HEAD_DIM * 2 + DET_BH * DET_N * 4)
    flash_flops = DET_BH * DET_N * DET_N * HEAD_DIM
    results.append(result(
        "flash_attention_fwd", "flash_attention.cu",
        "ssl4gie_tpu/kernels/flash_attention.py:136", err, ms, plain_ms,
        lib_ms, 4 * flash_flops, flash_bytes(3, 1)))
    print(f"[kernel] flash fwd   BH={DET_BH} N={DET_N} D={HEAD_DIM} bf16: "
          f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms  [{card}]",
          flush=True)

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
    lib_ms = sdpa_ms(bhnd(q), bhnd(k), bhnd(v), scale, bhnd(do))
    # q, k, v, o, dO in; dq, dk, dv out; the lse in
    results.append(result(
        "flash_attention_bwd", "flash_attention.cu",
        "ssl4gie_tpu/kernels/flash_attention.py:173", err, ms, plain_ms,
        lib_ms, 10 * flash_flops, flash_bytes(5, 3)))
    print(f"[kernel] flash bwd   same shapes: max|err|={err:.3g} (tol "
          f"{tol:.3g} rel) kernel {ms:.4f} ms "
          f"({tflops(10 * flash_flops, ms)}), plain (autograd) "
          f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms "
          f"({tflops(10 * flash_flops, lib_ms)})  [{card}]", flush=True)
    del q, k, v, do, o_k, lse_k

    # masked keys: N = 1024 with n_valid = 1000 (a partial last key tile)
    # and 3 (one key tile; dk/dv blocks whose keys are all masked)
    q, k, v, do = (rand(DET_BH, 1024, HEAD_DIM) for _ in range(4))
    for n_valid in (1000, 3):
        o_k, lse_k = fa.flash_fwd(q, k, v, scale, n_valid)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, n_valid)
        err = check_close("flash_fwd masked", o_k, o_p, tol)
        check_close("flash_fwd masked lse", lse_k, lse_p, 2.0 ** -16)
        grads_k = fa.flash_bwd(q, k, v, o_k, lse_k, do, scale, n_valid)
        torch.cuda.synchronize()
        grads_p = fa.flash_attention_bwd_plain(q, k, v, do, scale, n_valid)
        err = max([err] + [check_close(f"flash_bwd masked d{n}", g, r, tol)
                           for n, g, r in zip("qkv", grads_k, grads_p)])
        print(f"[kernel] flash masked BH={DET_BH} N=1024 n_valid={n_valid}: "
              f"fwd and bwd max|err|={err:.3g} (tol {tol:.3g} rel)  [{card}]",
              flush=True)
    return results


def cls_setup():
    """The full-width ViT-B/16 classifier (random weights from SEED), its
    optimizer, the full step, a synthetic uint8 batch and its labels on the
    card, and the augmentation's generator."""
    dev = torch.device("cuda")
    model = ViTClassifier(NUM_CLASSES, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED),
                          device=dev)
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label", loss_fn=weighted_cross_entropy)
    rng = np.random.default_rng(SEED)
    img_u8 = torch.from_numpy(
        rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=B)).to(dev)
    return (model, make_adamw(model.parameters(), LR), make_full_step(task),
            img_u8, labels, torch.Generator().manual_seed(SEED))


def main_path(card: str) -> dict:
    """The full-width finetune step, a few times; returns the launch counts."""
    model, optimizer, full_step, img_u8, labels, aug_gen = cls_setup()
    depth = len(model.backbone.blocks)
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
        ref_model = ViTClassifier(NUM_CLASSES, dtype=torch.float32,
                                  device="cpu")
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

MLP_SHAPES = {"encoder": (MAE_ENC_TOKENS, 768, 3072),
              "decoder": (MAE_DEC_TOKENS, MAE_DEC_DIM, 4 * MAE_DEC_DIM)}


def mlp_case(gen, m: int, c: int, hd: int):
    """bf16 x (m, c), nn.Linear-layout weights w1 (hd, c), w2 (c, hd), the
    biases, and dy (m, c) on the card."""
    dev = torch.device("cuda")
    rand = lambda *shape, std=1.0: (torch.randn(shape, generator=gen,
                                                device=dev) * std).bfloat16()
    return (rand(m, c), rand(hd, c, std=c ** -0.5), rand(hd, std=0.02),
            rand(c, hd, std=hd ** -0.5), rand(c, std=0.02), rand(m, c))


def mae_kernel_phase(card: str) -> list[dict]:
    """The fused MLP at the MAE encoder's and decoder's shapes and the dense
    attention at the decoder's Dh = 32, against their plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tol = 2.0 ** -6          # two bf16 ulps, as the attention kernels
    F = torch.nn.functional
    results = []
    for where, (m, c, hd) in MLP_SHAPES.items():
        x, w1, b1, w2, b2, dy = mlp_case(gen, m, c, hd)
        args = (x, w1.t(), b1, w2.t(), b2)
        y_k, h_k = fm.mlp_fwd(*args)
        torch.cuda.synchronize()
        y_p, h_p = fm.mlp_fwd_plain(*args)
        err = max(check_close(f"mlp_fwd {where} y", y_k, y_p, tol),
                  check_close(f"mlp_fwd {where} h", h_k, h_p, tol))
        del y_p, h_p
        ms = cuda_ms(lambda: fm.mlp_fwd(*args))
        plain_ms = cuda_ms(lambda: fm.mlp_fwd_plain(*args))
        unfused = lambda x_, w1_, b1_, w2_, b2_: F.linear(F.gelu(
            F.linear(x_, w1_, b1_), approximate="tanh"), w2_, b2_)
        unfused_ms = cuda_ms(lambda: unfused(x, w1, b1, w2, b2))
        w_bytes = (2 * c * hd + c + hd) * 2
        results.append(result(
            f"fused_mlp_fwd_{where}", "fused_mlp.cu",
            "ssl4gie_tpu/kernels/fused_mlp.py:75", err, ms, plain_ms, None,
            4 * m * c * hd, (2 * m * c + m * hd) * 2 + w_bytes,
            unfused_ms=unfused_ms))
        print(f"[kernel] fused MLP fwd {where} ({m} x {c} -> {hd}) bf16: "
              f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, unfused cuBLAS {unfused_ms:.4f} ms, "
              f"bound {results[-1]['bound_ms']:.4f} ms  [{card}]", flush=True)

        dh_k, g_k = fm.mlp_bwd(h_k, dy, w2.t())
        torch.cuda.synchronize()
        dh_p, g_p = fm.mlp_bwd_plain(h_k, dy, w2.t())
        err = max(check_close(f"mlp_bwd {where} dh", dh_k, dh_p, tol),
                  check_close(f"mlp_bwd {where} g", g_k, g_p, tol))
        del dh_p, g_p, dh_k, g_k
        ms = cuda_ms(lambda: fm.mlp_bwd(h_k, dy, w2.t()))
        plain_ms = cuda_ms(lambda: fm.mlp_bwd_plain(h_k, dy, w2.t()))
        # whole backwards: the fused one (kernel #9 + the four GEMMs and the
        # two sums) and autograd of the unfused cuBLAS sequence
        leaves = [t.detach().requires_grad_(True) for t in args]
        y = fm.fused_mlp(*leaves)
        fused_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y, leaves, dy, retain_graph=True))
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        y = unfused(*leaves)
        unfused_ms = cuda_ms(lambda: torch.autograd.grad(
            y, leaves, dy, retain_graph=True))
        del leaves, y
        results.append(result(
            f"fused_mlp_bwd_{where}", "fused_mlp.cu",
            "ssl4gie_tpu/kernels/fused_mlp.py:115", err, ms, plain_ms, None,
            2 * m * c * hd, (m * hd + m * c + 2 * m * hd) * 2 + c * hd * 2,
            unfused_ms=unfused_ms, fused_bwd_ms=fused_bwd_ms))
        print(f"[kernel] fused MLP bwd {where}: max|err|={err:.3g} (tol "
              f"{tol:.3g} rel) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {results[-1]['bound_ms']:.4f} ms; whole backward: "
              f"fused {fused_bwd_ms:.4f} ms, unfused cuBLAS autograd "
              f"{unfused_ms:.4f} ms  [{card}]", flush=True)
        del x, w1, b1, w2, b2, dy, args, h_k, y_k

    heads, dh = MAE_DEC_HEADS, MAE_DEC_DIM // MAE_DEC_HEADS
    scale = dh ** -0.5
    qkv = torch.randn((MAE_B, TOKENS, 3 * MAE_DEC_DIM), generator=gen,
                      device=dev).bfloat16()
    dout = torch.randn((MAE_B, TOKENS, MAE_DEC_DIM), generator=gen,
                       device=dev).bfloat16()
    out_k, lse_k = da.attention_fwd(qkv, heads, scale)
    torch.cuda.synchronize()
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, scale)
    err = check_close("attention_fwd Dh=32", out_k, out_p, tol)
    check_close("attention_fwd Dh=32 lse", lse_k, lse_p, 2.0 ** -16)
    ms = cuda_ms(lambda: da.attention_fwd(qkv, heads, scale))
    plain_ms = cuda_ms(lambda: da.fused_qkv_attention_plain(qkv, heads, scale))
    q, k, v = heads_of(qkv, heads)
    lib_ms = sdpa_ms(q, k, v, scale)
    results.append(result(
        "dense_attention_fwd_dh32", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:64", err, ms, plain_ms,
        lib_ms, *attn_work(MAE_B, heads, TOKENS, dh, False)))
    print(f"[kernel] attention fwd  B={MAE_B} N={TOKENS} H={heads} Dh={dh} "
          f"bf16: max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms  [{card}]",
          flush=True)
    dq_k = da.attention_bwd(qkv, out_k, lse_k, dout, heads, scale)
    torch.cuda.synchronize()
    err = check_close("attention_bwd Dh=32", dq_k, da.fused_qkv_attention_bwd_plain(
        qkv, dout, heads, scale), tol)
    ms = cuda_ms(lambda: da.attention_bwd(qkv, out_k, lse_k, dout, heads,
                                          scale))
    x = qkv.detach().requires_grad_(True)
    o = da.fused_qkv_attention_plain(x, heads, scale)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(o, x, dout,
                                                   retain_graph=True))
    del x, o
    lib_ms = sdpa_ms(q, k, v, scale, split_heads(dout, heads))
    work = attn_work(MAE_B, heads, TOKENS, dh, True)
    results.append(result(
        "dense_attention_bwd_dh32", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:90", err, ms, plain_ms,
        lib_ms, *work))
    print(f"[kernel] attention bwd  same shapes: max|err|={err:.3g} (tol "
          f"{tol:.3g} rel) kernel {ms:.4f} ms ({tflops(work[0], ms)}), plain "
          f"(autograd) {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms "
          f"({tflops(work[0], lib_ms)})  [{card}]", flush=True)
    return results


MAE_COUNTERS = {"fused_mlp_fwd": fm.mlp_fwd, "fused_mlp_bwd": fm.mlp_bwd,
                "dense_attention_fwd_dh32": da.attention_fwd,
                "dense_attention_bwd_dh32": da.attention_bwd}


def mae_setup():
    """The full-width MAE ViT-B (random weights from SEED, bf16 compute over
    f32 masters), its optimizer, the full step, a synthetic uint8 batch of
    256 px canvases on the card and a generator."""
    dev = torch.device("cuda")
    cfg = MAEPretrainConfig(batch_size=MAE_B)
    model = MAE(img_size=cfg.img_size, mask_ratio=cfg.mask_ratio,
                norm_pix_loss=cfg.norm_pix_loss, dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(SEED), device=dev)
    src = SyntheticUnlabeled(MAE_B, canvas=MAE_CANVAS, seed=SEED)
    img_u8 = torch.from_numpy(src.batch(range(MAE_B))["image"]).to(dev)
    # the recipe's per-step warmup then cosine, over a short horizon so that
    # the smoke steps take nonzero rates
    schedule = make_schedule(cfg.effective_lr(), 2, 100)
    return (model, make_mae_optimizer(model, cfg),
            make_mae_full_step(schedule, cfg.img_size), img_u8,
            torch.Generator(device=dev).manual_seed(SEED))


def mae_path(card: str) -> dict:
    """The full-width MAE pretraining step with the fused MLP on, a few
    times; returns the launch counts."""
    dev = torch.device("cuda")
    model, optimizer, full_step, img_u8, gen = mae_setup()
    enc, dec = len(model.blocks), len(model.decoder_blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_flag = layers.FUSED_MLP
    layers.FUSED_MLP = True          # this phase only
    try:
        for fn in MAE_COUNTERS.values():
            fn.launches = 0
        fm.mlp_fwd.by_width.clear()
        fm.mlp_bwd.by_width.clear()
        outs = []
        n_steps = MAE_WARMUP_STEPS + MAE_TIMED_STEPS
        for step in range(n_steps):
            if step == MAE_WARMUP_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            outs.append(full_step(model, optimizer, img_u8, gen, step))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in MAE_COUNTERS.items()}
        expected = {"fused_mlp_fwd": (enc + dec) * n_steps,
                    "fused_mlp_bwd": (enc + dec) * n_steps,
                    "dense_attention_fwd_dh32": dec * n_steps,
                    "dense_attention_bwd_dh32": dec * n_steps}
        print(f"[mae] launches over {n_steps} steps: {launches} (expected "
              f"{expected}); fused MLP by width: fwd "
              f"{dict(fm.mlp_fwd.by_width)}, bwd {dict(fm.mlp_bwd.by_width)}",
              flush=True)
        if launches != expected:
            raise AssertionError("the MAE path did not run through the "
                                 f"kernels as expected: {launches} != "
                                 f"{expected}")
        counts = {}
        for d, where, blocks in ((768, "encoder", enc), (MAE_DEC_DIM,
                                                         "decoder", dec)):
            for kind, fn in (("fwd", fm.mlp_fwd), ("bwd", fm.mlp_bwd)):
                counts[f"fused_mlp_{kind}_{where}"] = fn.by_width[d]
                if fn.by_width[d] != blocks * n_steps:
                    raise AssertionError(f"fused MLP {kind} at width {d}: "
                                         f"{fn.by_width[d]} launches")
        counts.update({k: v for k, v in launches.items()
                       if k.startswith("dense")})
        hist = [{k: float(v) for k, v in o.items()} for o in outs]
        print(f"[mae] loss / grad_norm: {hist}", flush=True)
        if not all(np.isfinite(list(h.values())).all() for h in hist):
            raise AssertionError(f"non-finite MAE loss or gradient norm: "
                                 f"{hist}")
        ms_step = dt / MAE_TIMED_STEPS * 1e3
        print(f"[mae] MAE ViT-B/16 224 px pretraining step, B={MAE_B}, bf16 "
              f"compute / f32 AdamW, fused MLP on, mae_augment on device: "
              f"{ms_step:.2f} ms/step, {MAE_B * MAE_TIMED_STEPS / dt:.1f} "
              f"img/s (mean of {MAE_TIMED_STEPS} steps after "
              f"{MAE_WARMUP_STEPS} warm-up), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
              flush=True)
        # the same step with the fused MLP off (cuBLAS GEMMs around the
        # plain GELU), for comparison only
        layers.FUSED_MLP = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(n_steps, n_steps + MAE_TIMED_STEPS):
            full_step(model, optimizer, img_u8, gen, step)
        torch.cuda.synchronize()
        off_ms = (time.perf_counter() - t0) / MAE_TIMED_STEPS * 1e3
        layers.FUSED_MLP = True
        print(f"[mae] the same step with the fused MLP off: {off_ms:.2f} "
              f"ms/step, {MAE_B / off_ms * 1e3:.1f} img/s (mean of "
              f"{MAE_TIMED_STEPS} steps)  [{card}]", flush=True)

        # one bf16 forward with the fused MLP against the same forward
        # without it: same weights, batch and noise; the first goes through
        # the kernel in all 20 MLPs, the second in none
        imgs = mae_augment(img_u8, sample_mae_params(MAE_B, gen, MAE_CANVAS))
        noise = model.draw_noise(MAE_B, gen)
        with torch.no_grad():
            n0 = fm.mlp_fwd.launches
            loss_on, pred_on = (t.float() for t in model(imgs, noise)[:2])
            n1 = fm.mlp_fwd.launches
            layers.FUSED_MLP = False
            loss_off, pred_off = (t.float() for t in model(imgs, noise)[:2])
            layers.FUSED_MLP = True
        if (n1 - n0, fm.mlp_fwd.launches - n1) != (enc + dec, 0):
            raise AssertionError("the agreement forwards did not take the "
                                 "fused and the unfused MLP routes")
        loss_on, loss_off = float(loss_on), float(loss_off)
        rel = abs(loss_on - loss_off) / abs(loss_off)
        print(f"[mae] bf16 loss with the fused MLP {loss_on:.9g}, without "
              f"{loss_off:.9g}: relative difference {rel:.3g} (tol "
              f"{MAE_LOSS_TOL}); pred max|diff| "
              f"{(pred_on - pred_off).abs().max().item():.4g} at max|pred| "
              f"{pred_off.abs().max().item():.4g}", flush=True)
        if not rel <= MAE_LOSS_TOL:
            raise AssertionError(f"fused and unfused MLP losses disagree: "
                                 f"{rel} > {MAE_LOSS_TOL}")
        del pred_on, pred_off

        # the card's bf16 model against a float32 CPU run of the same
        # weights on a small input (plain attention and MLP on the CPU)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        ref_model = MAE(dtype=torch.float32, device="cpu")
        ref_model.load_state_dict(sd)
        x, nz = imgs[:MAE_REF_B], noise[:MAE_REF_B]
        with torch.no_grad():
            pred = model(x, nz)[1].float().cpu()
            ref = ref_model(x.cpu(), nz.cpu())[1]
    finally:
        layers.FUSED_MLP = fused_flag
    err = (pred - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[mae] pred bf16 on card vs f32 on CPU (B={MAE_REF_B}): "
          f"max|err|={err:.4g}, max|ref|={scale:.4g}", flush=True)
    if not bool(torch.isfinite(pred).all()) or err > LOGIT_TOL * scale:
        raise AssertionError(f"MAE predictions disagree: {err} > {LOGIT_TOL} "
                             f"* {scale}")
    return counts



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
    small = FasterRCNN(image_size=DET_REF_IMG, dtype=torch.bfloat16,
                       device="cpu")
    small.load_state_dict(sd)
    ref_model = FasterRCNN(image_size=DET_REF_IMG, dtype=torch.float32,
                           device="cpu")
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


def profile_steps(card: str, step, n_steps: int, out_dir: str, name: str):
    """torch.profiler over `n_steps` calls of `step` (after one warm-up
    call): writes the table of device time by kernel to out_dir/name, prints
    the device's busy share and the top kernels. Returns the events and the
    wall ms/step under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    Path(out_dir, name).write_text(
        f"{card}\nwall {wall:.2f} ms/step over {n_steps} steps "
        f"under the profiler\n{table}\n")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    print(f"[profile] {name}: wall {wall:.2f} ms/step under the profiler, "
          f"device kernels {dev_ms:.2f} ms/step (busy share "
          f"{dev_ms / wall:.3f})  [{card}]", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:9.3f} "
              f"ms/step  x{e.count // n_steps:<6d} {e.key[:90]}")
    return events, wall


def profile_cls(card: str, out_dir: str) -> None:
    """torch.profiler over TIMED_STEPS classification steps."""
    model, optimizer, full_step, img_u8, labels, aug_gen = cls_setup()
    profile_steps(card, lambda: full_step(model, optimizer, img_u8, labels,
                                          aug_gen),
                  TIMED_STEPS, out_dir, "cls_profile.txt")


def profile_mae(card: str, out_dir: str) -> None:
    """torch.profiler over MAE_TIMED_STEPS MAE steps, fused MLP on."""
    model, optimizer, full_step, img_u8, gen = mae_setup()
    fused_flag = layers.FUSED_MLP
    layers.FUSED_MLP = True
    try:
        profile_steps(card, lambda: full_step(model, optimizer, img_u8, gen,
                                              1),
                      MAE_TIMED_STEPS, out_dir, "mae_profile.txt")
    finally:
        layers.FUSED_MLP = fused_flag


def profile_det(card: str, out_dir: str) -> None:
    """torch.profiler over DET_TIMED_STEPS detection steps after one warm-up:
    device time by kernel, the device's busy share, and the NMS slot loop's
    host time ("nms_topk" range); the table goes to out_dir."""
    from ssl4gie_tpu_torch.ops.nms import nms_topk
    model, optimizer, full_step, batch, gen = det_setup()
    events, wall = profile_steps(
        card, lambda: full_step(model, optimizer, batch, gen),
        DET_TIMED_STEPS, out_dir, "det_profile.txt")
    # the "nms_topk" range on the device timeline: first to last kernel of
    # the slot loop, idle gaps included
    nms = [e for e in events if e.key == "nms_topk"]
    nms_ms = max((e.device_time_total for e in nms), default=0) / 1e3 / \
        DET_TIMED_STEPS
    print(f"[profile] detection step: nms_topk span {nms_ms:.2f} ms/step "
          f"({nms_ms / wall:.3f} of wall)  [{card}]", flush=True)
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
                        help="also profile the classification, detection "
                             "and MAE steps; the tables go to DIR")
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
              ("kernels (MAE shapes)", mae_kernel_phase),
              ("classification path", main_path),
              ("detection path", det_path),
              ("MAE path", mae_path)]
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
        profile_cls(card, args.profile)
        profile_det(card, args.profile)
        profile_mae(card, args.profile)
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
