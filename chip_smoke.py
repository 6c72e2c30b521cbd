#!/usr/bin/env python3
"""Drive the PyTorch port (`ssl4gie_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from `ssl4gie_tpu_torch/csrc/` (first use) and
   prints each kernel's registers and spills (ptxas) and the fused MLP's
   shared memory per block.
2. Kernel phases: each kernel against its plain PyTorch version on the card
   at its path's shapes, with its time, the plain version's, the one
   PyTorch call that computes the same function where there is one
   (`F.scaled_dot_product_attention` on contiguous (B, H, N, Dh) tensors;
   the head-split copies are not counted) and its bound (the larger of its
   FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s, each input read
   once and each output written once). Times are CUDA-event medians; each
   backward also prints its rate, counting the five products of the
   function (S, dP, dV, dQ, dK) as the bound does.
   - classification: B=64 images, ViT-B/16 attention N=197 H=12 Dh=64;
     the same kernels also held to their plain versions
     and timed at the seg and ViT depth steps' B=48;
   - rotation, at its path shapes (the ViT classification batch, 64 x 224
     x 224 x 3, the segmentation affine's canvas, 48 x 352 x 352 x 5, of
     the ViT and the RN50 seg steps, and the RN50 classification batch, 48
     x 224 x 224 x 3), at random and boundary angles, element for element,
     per call and back to back, cycling over input/output pairs that
     exceed the card's 50 MB L2
     (`ssl4gie_tpu_torch/benchmarks/bench_rotate.py`);
   - detection: windowed attention on a (4, 64, 64, 3*768) grid with 16x16
     windows, flash attention at (48, 4096, 64), the two forwards also at
     the eval batch of 2 ((2, 64, 64, 3*768) and (24, 4096, 64)), and
     masked flash cases (N=1024, n_valid=1000 and 3);
   - MAE: the fused MLP forward and backward at the encoder's (12800
     tokens, 768 -> 3072) and the decoder's (50432 tokens, 512 -> 2048)
     shapes, also against the unfused cuBLAS sequence F.linear -> F.gelu
     (tanh) -> F.linear and its backward (`unfused_ms`), each also timed
     over 20 calls back to back (`b2b_ms`: the host's launch time hidden),
     the forward's two products alone at their N tile and at the other N
     tile that divides C (`products_b2b_ms`); and the dense attention at
     Dh=32, (256, 197, 3*512), 16 heads;
   - A/B variants (the kernels of the JAX package's kernel harnesses):
     every configuration that a harness leg launches (#10 packed-QKV v2 at
     G 2 and 4, Nb 256 and 208, and #11 save-P at G 2, Nb 208, at the
     classification shapes; #12 window v2 at G 1, 2, 4 at the detection
     grid), beside #1/#2 and #4/#5 timed in the same phase; #11's bound
     counts its own work (four backward products, P's n x n bytes).
3. Classification path: the ViT-B/16 224 px finetune step at full width
   (uint8 batch -> on-device augmentation -> forward/backward -> AdamW), a few
   steps from random weights made from a seed. The kernels' launch counters
   must grow by exactly 12 attention forwards, 12 attention backwards and one
   rotation per step; the losses must be finite; the model's logits must agree
   with a float32 CPU run of the same weights on a small input.
   Then the dense-task and RN50 paths (DENSE_PATHS), each at full width,
   B=48, a few steps: the ViT-B/16 + DPT segmentation step (uint8 batch
   and 0/1 masks -> on-device seg augmentation: jitter, blur, normalize,
   joint flips, the joint random affine whose rotation runs on the 352 px
   canvas -> forward/backward of the soft Dice loss with BatchNorm in
   train mode and the head's dropout -> AdamW; 12 attention forwards, 12
   backwards and one rotation per step), the RN50 + DeepLabV3+
   segmentation step (the same augmentation and loss; one rotation per
   step), the ViT-B/16 + DPT depth step (the depth augmentation, the SSI
   loss; 12 + 12 attention launches per step), the RN50 + the
   reference's decoder depth step (no kernel) and the RN50 classification
   step (the classification augmentation; one rotation per step). Every
   kernel counter must grow by exactly those launches and the others by
   none; the losses must be finite; the bf16 eval output must agree with
   a float32 CPU run of the same weights and BatchNorm statistics at B=2.
   Each prints ms/step, img/s and peak memory.
4. Detection path: the ViT-B Faster R-CNN train step at full width, 1024 px,
   B=4 (uint8 batch -> on-device `detection_augment` -> forward/backward of
   the four losses -> AdamW), a few steps. The counters must grow by exactly
   8 window forwards, 8 window backwards, 4 flash forwards and 4 flash
   backwards per step; the losses must be finite; one eval forward must give
   detections of the expected shapes; the backbone's map must agree with a
   float32 CPU run of the same weights on a small (512 px) input.
   Then the RN50-FPN Faster R-CNN train step at full width, 1344 px, B=4
   (the same step): no kernel launches, finite losses, the body's
   BatchNorm running statistics bitwise unchanged (frozen), the bf16 FPN
   maps against a float32 CPU run at 256 px, B=2. Then `evaluate_map` at
   batch 2 over five frames for both detectors: the RN50 at 1344 px with
   torchvision placement (content sizes 1000 x 800 ... 1333 x 744, so the
   batch-max emulation masks), no kernel launches; the ViT-B at 1024 px,
   exactly 8 window and 4 flash forwards per eval batch; a finite mAP
   dict. Each prints ms per step or per eval batch, img/s and peak memory.
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
6. Kernel A/B harnesses: every leg of the ported harnesses
   (`ssl4gie_tpu_torch/benchmarks/bench_attention_kernel.py` at B=128,
   L=12; `bench_window_kernel.py` at B=2, L=8) for a few steps. One layer
   of each kernel leg, at the leg's configuration and on the harness's own
   input, must agree with its kernels' plain versions (output and gradient,
   2^-6); each kernel leg's counters must grow by exactly L forwards and L
   backwards per step (the plain leg's by none); the losses must be
   finite; each leg prints its median ms/step.
7. Finetune driver: the port's `build_trainer` on the command line a user
   gives `cli/train.py` (ViT-B/16 classification at full width, bf16 over
   f32 masters, B=64, --learning-rate-scheduler, a synthetic split of 320
   images: 5 train steps and 5 val and 5 test batches an epoch; the
   checkpoint and the log in a temporary directory, removed after),
   `fit()` for two epochs (the Loader, the pinned copies, the on-device
   augmentation, val and test, the plateau, the best-val save), the end
   state written as the requeue slot of a run preempted after its second
   epoch, a second `build_trainer` with --epochs 3 that resumes at epoch 3
   (the restored weights and AdamW moments bitwise the saved ones) and runs
   it, then `cli.evaluate.main` on the best-val slot (mF1, mPrecision,
   mRecall, Accuracy). The counters must grow by exactly 12 attention
   forwards, 12 backwards and one rotation per train step and 12 forwards
   per eval batch, nothing else; the losses must be finite and each ledger
   payload one of the JAX Trainer's. Prints the driver's step time and
   img/s beside the bare step's (measured just before), the Loader's
   batches/s alone, ms per eval batch, the host copies of the state, the
   best-val save, the checkpoint's size, the resume's load and peak memory.
8. MoCo v3 path: the full-width MoCo v3 step (dim 256, mlp_dim 4096, bf16
   over f32 masters) on vit_b (AdamW at the warmup-cosine rate, the patch
   projection frozen), vit_s (heads 32 wide), vit_conv_b (the conv stem,
   11 blocks) and resnet50 (LARS), each built by `build_pretraining` from
   the config `cli/pretrain.py` makes, at B=128 (224 px crops of 256 px
   uint8 canvases -> on-device `moco_two_crops` -> EMA -> momentum
   encoder on both views without gradient -> encoder and predictor on
   both -> symmetric InfoNCE -> backward -> optimizer), a few steps. The
   counters must grow by exactly 4 x depth attention forwards and 2 x
   depth backwards per step (48 + 24 at depth 12, 44 + 22 at 11; none for
   RN50); losses and gradient norms must be finite; the frozen patch
   projection must be bitwise unchanged in both encoders (a conv stem
   must move); one more step's momentum parameters must equal m * old +
   (1 - m) * encoder, recomputed; the bf16 projector output must agree
   with a float32 CPU run of the same weights and statistics at B=2. The
   kernel phase holds #1/#2 at (128, 197, 3*768), 12 x 64, and (128, 197,
   3*384), 12 x 32 (the forward also under no_grad).
9. Pretrain driver: `cli/pretrain.py`'s config and `run` on `--framework
   mocov3 --arch vit_b --synthetic --batch-size 128` over 384 synthetic
   canvases (3 steps an epoch) in a temporary directory: two epochs with
   --keep-last 1, a second run with --epochs 3 that resumes from the
   `.resume` slot (weights, momentum weights, statistics, AdamW state and
   step bitwise the first run's) and runs the third, then one MAE vit_b
   epoch. Counters per step as above (MAE 8 + 8 at Dh 32), finite losses,
   the JAX loop's ledger keys, the slots left; prints the driver's ms/step
   beside the bare MoCo step's, the saves' and loads' times and the slots'
   sizes.
10. Prints the card's name and power limit, one JSON line of per-kernel
   results, then the last line
   `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

    python3 chip_smoke.py --profile DIR

also profiles a few classification, segmentation, RN50 segmentation, ViT
depth, ViT and RN50 detection, MAE and MoCo vit_b steps, one ViT detection eval batch
and one epoch of the finetune driver (5 train steps, the Loader and the
copies included) with `torch.profiler` (device time by kernel, the
device's busy share, the NMS slot loops' span, the RN50 and depth steps'
NCHW <-> NHWC layout conversions) and writes the tables to DIR.

Any failure raises (nonzero exit, no result). There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ssl4gie_tpu_torch.benchmarks import bench_attention_kernel as bak
from ssl4gie_tpu_torch.benchmarks import bench_rotate as brot
from ssl4gie_tpu_torch.benchmarks import bench_window_kernel as bwk
from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.cli import evaluate as cli_evaluate
from ssl4gie_tpu_torch.cli import pretrain as cli_pretrain
from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                           PretrainConfig)
from ssl4gie_tpu_torch.core.schedule import cosine_momentum
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.data.augment import eval_batch, normalize
from ssl4gie_tpu_torch.data.ssl_augment import (mae_augment, moco_two_crops,
                                                sample_mae_params,
                                                sample_moco_params)
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import attention_variants as av
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import fused_mlp as fm
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.kernels import window_attention as wa
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models import layers
from ssl4gie_tpu_torch.models.factory import (DeepLabV3Plus, ResNetClassifier,
                                              ResNetDepthModel, ViTDenseModel)
from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.ssl.mae import MAE
from ssl4gie_tpu_torch.ssl.moco_v3 import (STOP_GRAD_ARCHS, VIT_PRESETS,
                                           MoCoEncoder)
from ssl4gie_tpu_torch.ssl.pretrain import (PretrainRun, SyntheticUnlabeled,
                                            build_pretraining,
                                            make_mae_full_step,
                                            make_mae_optimizer, make_schedule)
from ssl4gie_tpu_torch.tasks.detection import (TV_CANVAS, DetectionSource,
                                               SyntheticDetectionSource,
                                               evaluate_map,
                                               make_detection_eval_step,
                                               make_detection_full_step)
from ssl4gie_tpu_torch.tasks.build import build_trainer
from ssl4gie_tpu_torch.tasks.depth import depth_task
from ssl4gie_tpu_torch.tasks.segmentation import segmentation_task

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
# the RN50 detector: torchvision's 1333 rounded up to /32
# (benchmarks/bench_detection.py:28), the ViT detector's batch; its bf16 FPN
# maps are held to f32 on the CPU at 256 px, B = 2
RN50_DET_REF_IMG, RN50_DET_REF_B = 256, 2
# evaluate_map: the JAX package's eval batch of 2 over five frames (the tail
# padded). The RN50 frames (w, h) resize (torchvision: min(800 / short,
# 1333 / long)) to the content sizes torchvision gives Kvasir frames, whose
# batch-max extents (1024 x 800, 1344 x 800, 1088 x 800) lie below the
# canvas; the ViT frames are centered on the 1024 px canvas
EVAL_B = 2
RN50_EVAL_FRAMES = ((650, 520), (650, 553), (716, 400), (560, 560),
                    (652, 489))
RN50_EVAL_CONTENT = ((1000, 800), (940, 800), (1333, 744), (800, 800),
                     (1066, 800))
VIT_EVAL_FRAMES = ((622, 529), (576, 720), (1000, 800), (720, 576),
                   (1024, 1024))
MAE_B, MAE_CANVAS = 256, 256       # ROADMAP's H100 row "MAE B=256"
MAE_ENC_TOKENS = MAE_B * 50        # 49 kept patches + cls
MAE_DEC_TOKENS = MAE_B * 197
MAE_DEC_HEADS, MAE_DEC_DIM = 16, 512
MAE_WARMUP_STEPS, MAE_TIMED_STEPS = 1, 3
MAE_LOSS_TOL = 0.01     # fused vs unfused MLP forward: 1% of the loss
MAE_REF_B = 2
HARNESS_WARMUP_STEPS, HARNESS_TIMED_STEPS = 1, 5
# MoCo v3: benchmarks/bench_moco_pretrain.py's batch, 224 px crops of 256 px
# canvases; the four archs the phase drives (vit_conv_s shares vit_s's
# attention shapes and vit_conv_b's stem)
MOCO_B, MOCO_CANVAS = 128, 256
MOCO_WARMUP_STEPS, MOCO_TIMED_STEPS = 1, 3
MOCO_ARCHS = ("vit_b", "vit_s", "vit_conv_b", "resnet50")
MOCO_REF_B = 2
MOCO_MS_STEP = {}      # each arch's bare step, ms (the driver's yardstick)
# segmentation: the batch of benchmarks/bench_segmentation.py, and the
# random affine's rotation canvas at 224 px (image, mask, validity: 5 channels)
SEG_B, SEG_CANVAS = 48, 352
SEG_WARMUP_STEPS, SEG_TIMED_STEPS = 1, 3
SEG_REF_B = 2
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


def cuda_ms_b2b(fn, runs: int = 20, warmup: int = 3) -> float:
    """Device time of `fn` per call over `runs` calls issued back to back
    between two CUDA events: the host's time to launch is hidden where it is
    shorter than the device's (cuda_ms counts it from the first event)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


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


def save_p_work(seqs: int, heads: int, n: int, dh: int, backward: bool):
    """FLOPs and bytes of save-P attention (#11) over `seqs` sequences:
    forward 2 products (Q.K^T, P.V), backward 4 (dP, dV, dQ, dK) of
    2 n^2 dh each per head; bytes: forward qkv in, out and P (heads x n x n
    bf16 a sequence, whatever the layout pads it to) out; backward qkv, P
    and dO in, dqkv out."""
    tok, c = seqs * n, heads * dh
    p = seqs * heads * n * n * 2
    flops = (8 if backward else 4) * seqs * heads * n * n * dh
    if backward:
        return flops, tok * (3 * c + c + 3 * c) * 2 + p
    return flops, tok * (3 * c + c) * 2 + p


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

    # the segmentation and ViT depth steps run the same kernels at B = SEG_B
    qkv_s, dout_s = qkv[:SEG_B].contiguous(), dout[:SEG_B].contiguous()
    out_s, lse_s = da.attention_fwd(qkv_s, HEADS, scale)
    dq_s = da.attention_bwd(qkv_s, out_s, lse_s, dout_s, HEADS, scale)
    torch.cuda.synchronize()
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv_s, HEADS, scale)
    err_f = check_close("attention_fwd (seg batch)", out_s, out_p, tol)
    check_close("attention_fwd lse (seg batch)", lse_s, lse_p, 2.0 ** -16)
    err_b = check_close("attention_bwd (seg batch)", dq_s,
                        da.fused_qkv_attention_bwd_plain(qkv_s, dout_s, HEADS,
                                                         scale), tol)
    q, k, v = heads_of(qkv_s, HEADS)
    fwd = result(
        "dense_attention_fwd_seg", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:64", err_f,
        cuda_ms(lambda: da.attention_fwd(qkv_s, HEADS, scale)),
        cuda_ms(lambda: da.fused_qkv_attention_plain(qkv_s, HEADS, scale)),
        sdpa_ms(q, k, v, scale),
        *attn_work(SEG_B, HEADS, TOKENS, HEAD_DIM, False))
    x = qkv_s.detach().requires_grad_(True)
    o = da.fused_qkv_attention_plain(x, HEADS, scale)
    bwd = result(
        "dense_attention_bwd_seg", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:90", err_b,
        cuda_ms(lambda: da.attention_bwd(qkv_s, out_s, lse_s, dout_s, HEADS,
                                         scale)),
        cuda_ms(lambda: torch.autograd.grad(o, x, dout_s,
                                            retain_graph=True)),
        sdpa_ms(q, k, v, scale, split_heads(dout_s, HEADS)),
        *attn_work(SEG_B, HEADS, TOKENS, HEAD_DIM, True))
    del x, o
    # the ViT depth step's entries: the same shapes, timed once
    results += [fwd, bwd, dict(fwd, name="dense_attention_fwd_vit_depth"),
                dict(bwd, name="dense_attention_bwd_vit_depth")]
    print(f"[kernel] attention fwd / bwd at the seg and depth steps' "
          f"B={SEG_B}: max|err| {err_f:.3g} / {err_b:.3g} (tol {tol:.3g} "
          f"rel); kernel {fwd['ms']:.4f} / {bwd['ms']:.4f} ms, plain "
          f"{fwd['plain_ms']:.4f} / {bwd['plain_ms']:.4f} ms, sdpa "
          f"{fwd['library_ms']:.4f} / {bwd['library_ms']:.4f} ms  [{card}]",
          flush=True)
    return results


def rotate_kernel_phase(card: str) -> list[dict]:
    """The rotation kernel against its plain version at its path shapes,
    element for element at random angles and the boundary angles;
    timed per call through the wrapper and back to back by its C entry
    point, cycling over input/output pairs that exceed the card's L2
    (`benchmarks/bench_rotate.py`, which also compares two checkouts)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = []
    for name, shape in brot.SHAPES.items():
        nb, h, w, c = shape
        gs, factors = brot.rotation_case(shape, gen)
        brot.check_exact(gs, factors)
        per_call, entry = brot.cycled(gs, factors)
        ms, b2b_ms = brot.per_call_ms(per_call), brot.back_to_back_ms(entry)
        q, alpha, beta = factors
        g, pairs = gs[0], len(gs)
        plain_ms = cuda_ms(lambda: rot.shear_rotate_plain(g, alpha, beta, 0.0,
                                                          quarter=q))
        del gs, g
        # no matrix products; bytes: the image in and out, 3 numbers an image
        nbytes = 2 * math.prod(shape) * 2 + nb * 3 * 4
        r = result(name, "rotate.cu", "ssl4gie_tpu/kernels/rotate.py:33", 0.0,
                   ms, plain_ms, None, 0, nbytes, shape=list(shape),
                   b2b_ms=b2b_ms)
        results.append(r)
        print(f"[kernel] {name} {nb}x{h}x{w}x{c} bf16 (rot90 fold in the "
              f"kernel): element-exact; {ms:.4f} ms per call, {b2b_ms:.4f} ms "
              f"back to back ({r['bound_ms'] / b2b_ms:.2f} of the bound; "
              f"{brot.B2B_RUNS} launches cycling over {pairs} input/output "
              f"pairs, past the L2), plain {plain_ms:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms  [{card}]", flush=True)
    # the RN50 seg step's affine runs the seg canvas: the same shape, timed
    # once
    seg = next(r for r in results if r["name"] == "shear_rotate_seg")
    return results + [dict(seg, name="shear_rotate_rn50_seg")]


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

    # the ViT eval batch (evaluate_map's EVAL_B images): the two forwards
    qkv = rand(EVAL_B, DET_GRID, DET_GRID, 3 * C)
    out_k, lse_k = wa.window_attention_fwd(qkv, *args)
    torch.cuda.synchronize()
    out_p, lse_p = wa.windowed_attention_fwd_plain(qkv, *args)
    err = check_close("window_attention_fwd (eval batch)", out_k, out_p, tol)
    check_close("window_attention_fwd lse (eval batch)", lse_k, lse_p,
                2.0 ** -16)
    q, k, v = heads_of(wa.partition(qkv, DET_WINDOW), HEADS)
    win = result(
        "window_attention_fwd_eval", "window_attention.cu",
        "ssl4gie_tpu/kernels/window_attention.py:93", err,
        cuda_ms(lambda: wa.window_attention_fwd(qkv, *args)),
        cuda_ms(lambda: wa.windowed_attention_fwd_plain(qkv, *args)),
        sdpa_ms(q, k, v, scale),
        *attn_work(EVAL_B * (DET_GRID // DET_WINDOW) ** 2, HEADS,
                   DET_WINDOW ** 2, HEAD_DIM, False))
    del qkv, out_k, lse_k, out_p, lse_p, q, k, v
    bh = EVAL_B * HEADS
    q, k, v = (rand(bh, DET_N, HEAD_DIM) for _ in range(3))
    o_k, lse_k = fa.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale)
    err = check_close("flash_fwd (eval batch)", o_k, o_p, tol)
    check_close("flash_fwd lse (eval batch)", lse_k, lse_p, 2.0 ** -16)
    bhnd = lambda t: t.view(EVAL_B, HEADS, DET_N, HEAD_DIM)
    flash = result(
        "flash_attention_fwd_eval", "flash_attention.cu",
        "ssl4gie_tpu/kernels/flash_attention.py:136", err,
        cuda_ms(lambda: fa.flash_fwd(q, k, v, scale)),
        cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, scale)),
        sdpa_ms(bhnd(q), bhnd(k), bhnd(v), scale),
        4 * bh * DET_N * DET_N * HEAD_DIM,
        4 * bh * DET_N * HEAD_DIM * 2 + bh * DET_N * 4)
    del q, k, v, o_k, lse_k, o_p, lse_p
    results += [win, flash]
    for r, shape in ((win, f"B={EVAL_B} grid {DET_GRID}x{DET_GRID}"),
                     (flash, f"BH={bh} N={DET_N} D={HEAD_DIM}")):
        print(f"[kernel] {r['name']} {shape} bf16: max|err|="
              f"{r['max_abs_err']:.3g} (tol {tol:.3g} rel) kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms  "
              f"[{card}]", flush=True)

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


def entry_name(fn, config) -> str:
    """A variant kernel's JSON name: its wrapper at one configuration, G or
    (G, Nb), e.g. attention_v2_fwd_g2_nb256."""
    config = config if isinstance(config, tuple) else (config,)
    return fn.__name__ + "".join(f"_{k}{v}" for k, v in zip(("g", "nb"),
                                                             config))


def variant_configs() -> list:
    """Every (wrapper, configuration) of a variant kernel that a leg of the
    two kernel A/B harnesses launches, in the harnesses' leg order."""
    return list(dict.fromkeys(
        (fn, config) for mod in (bak, bwk) for leg in mod.LEGS.values()
        for fn, config in leg.kernels if config is not None))


def variant_kernel_phase(card: str) -> list[dict]:
    """Every configuration of #10 and #11 that the harness legs launch at
    the classification shapes and of #12 at the detection grid, against
    their plain versions on the same inputs, beside #1/#2 and #4/#5
    (`current`) and SDPA timed in this phase."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    C = HEADS * HEAD_DIM
    scale = HEAD_DIM ** -0.5
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    tol = 2.0 ** -6          # two bf16 ulps, as the production kernels
    src = "benchmarks/bench_attention_kernel.py"
    configs = variant_configs()
    results, b2b_of = [], {}

    def timed(fn):
        """Per call and back to back (the host's launch time hidden)."""
        return cuda_ms(fn), cuda_ms_b2b(fn)

    def hold(fn, config, case):
        """One configuration against the plain version's outputs (the lse
        at 2^-16 relative, the rest at tol), then timed."""
        call, refs, source, replaces, plain_ms, lib_ms, work, current = case
        name = entry_name(fn, config)
        got = call(config)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        err = max(check_close(f"{name} output {i}", g, r,
                              2.0 ** -16 if g.dtype == torch.float32 else tol)
                  for i, (g, r) in enumerate(zip(got, refs)))
        del got
        ms, b2b = timed(lambda: call(config))
        G, nb = config if isinstance(config, tuple) else (config, None)
        extra = {"G": G, **({"Nb": nb} if nb else {})}
        r = result(name, source, replaces, err, ms, plain_ms, lib_ms, *work,
                   b2b_ms=b2b, current_ms=current[0],
                   current_b2b_ms=current[1], **extra)
        results.append(r)
        b2b_of[name] = b2b
        print(f"[kernel] {name}: max|err|={err:.3g} (tol {tol:.3g} rel) "
              f"kernel {ms:.4f} ms, back to back {b2b:.4f} ms "
              f"({tflops(work[0], b2b)}); current {current[0]:.4f} / "
              f"{current[1]:.4f} ms; plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [{card}]", flush=True)

    qkv, dout = rand(B, TOKENS, 3 * C), rand(B, TOKENS, C)
    q, k, v = heads_of(qkv, HEADS)
    sdpa_f = sdpa_ms(q, k, v, scale)
    sdpa_b = sdpa_ms(q, k, v, scale, split_heads(dout, HEADS))
    del q, k, v
    out_c, lse_c = da.attention_fwd(qkv, HEADS, scale)
    cur_f = timed(lambda: da.attention_fwd(qkv, HEADS, scale))
    cur_b = timed(lambda: da.attention_bwd(qkv, out_c, lse_c, dout, HEADS,
                                           scale))
    del out_c, lse_c
    # the backward kernels take the plain forward's outputs
    out_p, lse_p = av.packed_attention_v2_fwd_plain(qkv, HEADS, scale)
    dq_p = av.packed_attention_v2_bwd_plain(qkv, dout, HEADS, scale)
    nb_p = av.SAVE_P_ROWS[0]
    outs_p, p_p = av.packed_attention_save_p_fwd_plain(qkv, HEADS, scale,
                                                       nb_p)
    dqs_p = av.packed_attention_save_p_bwd_plain(qkv, p_p, dout, HEADS, scale)
    dense = {
        av.attention_v2_fwd: (
            lambda c: av.attention_v2_fwd(qkv, HEADS, scale, *c),
            (out_p, lse_p), "attention_variants.cu", f"{src}:67",
            cuda_ms(lambda: av.packed_attention_v2_fwd_plain(qkv, HEADS,
                                                           scale)),
            sdpa_f, attn_work(B, HEADS, TOKENS, HEAD_DIM, False), cur_f),
        av.attention_v2_bwd: (
            lambda c: av.attention_v2_bwd(qkv, out_p, lse_p, dout, HEADS,
                                          scale, *c),
            (dq_p,), "attention_variants.cu", f"{src}:88",
            cuda_ms(lambda: av.packed_attention_v2_bwd_plain(qkv, dout, HEADS,
                                                           scale)),
            sdpa_b, attn_work(B, HEADS, TOKENS, HEAD_DIM, True), cur_b),
        av.attention_save_p_fwd: (
            lambda c: av.attention_save_p_fwd(qkv, HEADS, scale, *c),
            (outs_p, p_p), "attention_variants.cu", f"{src}:182",
            cuda_ms(lambda: av.packed_attention_save_p_fwd_plain(
                qkv, HEADS, scale, nb_p)),
            sdpa_f, save_p_work(B, HEADS, TOKENS, HEAD_DIM, False), cur_f),
        av.attention_save_p_bwd: (    # P's width is the configuration's Nb
            lambda c: av.attention_save_p_bwd(qkv, p_p, dout, HEADS, scale,
                                              c[0]),
            (dqs_p,), "attention_variants.cu", f"{src}:206",
            cuda_ms(lambda: av.packed_attention_save_p_bwd_plain(
                qkv, p_p, dout, HEADS, scale)),
            sdpa_b, save_p_work(B, HEADS, TOKENS, HEAD_DIM, True), cur_b),
    }
    for fn, config in configs:
        if fn in dense:
            hold(fn, config, dense[fn])
    p_mb = p_p.numel() * 2 / 1e6
    p_ms = p_mb * 1e6 / PEAK_BYTES * 1e3
    savep = [b2b_of[entry_name(fn, c)] for fn, c in configs
             if fn in (av.attention_save_p_fwd, av.attention_save_p_bwd)]
    print(f"[kernel] save-P: P is {p_mb:.1f} MB, {p_ms:.4f} ms each way at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; back to back, forward + backward "
          f"{sum(savep):.4f} ms against #1/#2's {cur_f[1] + cur_b[1]:.4f} "
          f"ms; backward {savep[-1]:.4f} against #2's {cur_b[1]:.4f} ms  "
          f"[{card}]", flush=True)
    del qkv, dout, out_p, lse_p, dq_p, outs_p, p_p, dqs_p, dense

    wsrc = "benchmarks/bench_window_kernel.py"
    args = (HEADS, DET_WINDOW, scale)
    qkv = rand(DET_B, DET_GRID, DET_GRID, 3 * C)
    dout = rand(DET_B, DET_GRID, DET_GRID, C)
    q, k, v = heads_of(wa.partition(qkv, DET_WINDOW), HEADS)
    sdpa_f = sdpa_ms(q, k, v, scale)
    sdpa_b = sdpa_ms(q, k, v, scale,
                     split_heads(wa.partition(dout, DET_WINDOW), HEADS))
    del q, k, v
    out_c, lse_c = wa.window_attention_fwd(qkv, *args)
    cur_f = timed(lambda: wa.window_attention_fwd(qkv, *args))
    cur_b = timed(lambda: wa.window_attention_bwd(qkv, out_c, lse_c, dout,
                                                  *args))
    del out_c, lse_c
    n_win = DET_B * (DET_GRID // DET_WINDOW) ** 2
    out_p, lse_p = av.window_attention_v2_fwd_plain(qkv, *args)
    dq_p = av.window_attention_v2_bwd_plain(qkv, dout, *args)
    window = {
        av.window_v2_fwd: (
            lambda G: av.window_v2_fwd(qkv, *args, G), (out_p, lse_p),
            "window_attention_v2.cu", f"{wsrc}:58",
            cuda_ms(lambda: av.window_attention_v2_fwd_plain(qkv, *args)),
            sdpa_f, attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, False),
            cur_f),
        av.window_v2_bwd: (
            lambda G: av.window_v2_bwd(qkv, out_p, lse_p, dout, *args, G),
            (dq_p,), "window_attention_v2.cu", f"{wsrc}:84",
            cuda_ms(lambda: av.window_attention_v2_bwd_plain(qkv, dout,
                                                           *args)),
            sdpa_b, attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, True),
            cur_b),
    }
    for fn, config in configs:
        if fn in window:
            hold(fn, config, window[fn])
    missing = {entry_name(fn, c) for fn, c in configs} - set(b2b_of)
    if missing:
        raise AssertionError(f"harness configurations not held: {missing}")
    return results


CLS_TASK = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label", loss_fn=weighted_cross_entropy)


def cls_setup():
    """The full-width ViT-B/16 classifier (random weights from SEED), its
    optimizer, the full step, a synthetic uint8 batch and its labels on the
    card, and the augmentation's generator."""
    dev = torch.device("cuda")
    model = ViTClassifier(NUM_CLASSES, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED),
                          device=dev)
    rng = np.random.default_rng(SEED)
    img_u8 = torch.from_numpy(
        rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=B)).to(dev)
    return (model, make_adamw(model.parameters(), LR),
            make_full_step(CLS_TASK),
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

# every kernel's launch counter: a path's launches are checked on all of
# them (those it does not run must stay at 0)
COUNTERS = {"dense_attention_fwd": da.attention_fwd,
            "dense_attention_bwd": da.attention_bwd,
            "shear_rotate": rot.shear_rotate,
            "window_attention_fwd": wa.window_attention_fwd,
            "window_attention_bwd": wa.window_attention_bwd,
            "flash_attention_fwd": fa.flash_fwd,
            "flash_attention_bwd": fa.flash_bwd,
            "fused_mlp_fwd": fm.mlp_fwd, "fused_mlp_bwd": fm.mlp_bwd,
            "attention_v2_fwd": av.attention_v2_fwd,
            "attention_v2_bwd": av.attention_v2_bwd,
            "attention_save_p_fwd": av.attention_save_p_fwd,
            "attention_save_p_bwd": av.attention_save_p_bwd,
            "window_v2_fwd": av.window_v2_fwd,
            "window_v2_bwd": av.window_v2_bwd}


def check_launches(tag: str, expected: dict) -> dict:
    """Every kernel counter against `expected` (absent names: 0); returns
    the counts of the kernels that ran."""
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    want = {name: expected.get(name, 0) for name in COUNTERS}
    ran = {k: v for k, v in launches.items() if v}
    print(f"[{tag}] launches: {ran or 'none'} (all other kernels 0)",
          flush=True)
    if launches != want:
        raise AssertionError(f"the {tag} path did not run through the "
                             f"kernels as expected: {launches} != {want}")
    return ran


def dense_batch(kind: str):
    """A synthetic uint8 batch of SEG_B images on the card and its targets:
    0/1 masks (seg, as `benchmarks/bench_segmentation.py` makes them),
    depth maps in [0, 1) (depth, as `benchmarks/bench_depth.py`), or
    labels."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    img_u8 = torch.from_numpy(
        rng.integers(0, 256, (SEG_B, IMG, IMG, 3), dtype=np.uint8)).to(dev)
    if kind == "seg":
        t = (rng.random((SEG_B, IMG, IMG, 1)) > 0.5).astype(np.float32)
    elif kind == "depth":
        t = rng.random((SEG_B, IMG, IMG, 1)).astype(np.float32)
    else:
        t = rng.integers(0, NUM_CLASSES, size=SEG_B)
    return img_u8, torch.from_numpy(t).to(dev)


# The dense-task and RN50 paths, each at full width, B = SEG_B (the
# reference finetunes every task at 48): (what it is, the model (built from
# a dtype and a device), the task, the batch kind, kernel launches per
# step)
DENSE_PATHS = {
    "seg": ("ViT-B/16 + DPT 224 px segmentation step (BatchNorm in train "
            "mode, the head's Dropout(0.1) live; the seg affine on the "
            f"{SEG_CANVAS} px canvas)",
            lambda dt, dev, gen=None: ViTDenseModel(
                dense="seg", dtype=dt, generator=gen, device=dev),
            segmentation_task, "seg",
            {"dense_attention_fwd": 12, "dense_attention_bwd": 12,
             "shear_rotate": 1}),
    "rn50_seg": ("RN50 + DeepLabV3+ 224 px segmentation step (OS 16, ASPP "
                 "12/24/36, its Dropout(0.5) live; the seg affine on the "
                 f"{SEG_CANVAS} px canvas)",
                 lambda dt, dev, gen=None: DeepLabV3Plus(
                     1, dtype=dt, generator=gen, device=dev),
                 segmentation_task, "seg", {"shear_rotate": 1}),
    "vit_depth": ("ViT-B/16 + DPT 224 px depth step (SSI loss, alpha 0.1; "
                  "jitter, blur, joint flips)",
                  lambda dt, dev, gen=None: ViTDenseModel(
                      dense="depth", dtype=dt, generator=gen, device=dev),
                  depth_task, "depth",
                  {"dense_attention_fwd": 12, "dense_attention_bwd": 12}),
    "rn50_depth": ("RN50 + the reference's decoder 224 px depth step (SSI "
                   "loss, alpha 0.1)",
                   lambda dt, dev, gen=None: ResNetDepthModel(
                       dtype=dt, generator=gen, device=dev),
                   depth_task, "depth", {}),
    "rn50_cls": ("RN50 224 px classification step (6 classes; the "
                 "classification augmentation's rotation)",
                 lambda dt, dev, gen=None: ResNetClassifier(
                     NUM_CLASSES, dtype=dt, generator=gen, device=dev),
                 lambda: CLS_TASK, "cls", {"shear_rotate": 1}),
}


def dense_setup(tag: str):
    """A path of DENSE_PATHS: its model (bf16 compute over f32 masters,
    random weights from SEED) on the card, its optimizer, the full step,
    the batch and a generator on the card (augmentation factors, dropout)."""
    _, build, task, kind, _ = DENSE_PATHS[tag]
    dev = torch.device("cuda")
    model = build(torch.bfloat16, dev, torch.Generator().manual_seed(SEED))
    img_u8, targets = dense_batch(kind)
    return (model, make_adamw(model.parameters(), LR),
            make_full_step(task()), img_u8, targets,
            torch.Generator(device=dev).manual_seed(SEED))


def dense_path(tag: str, card: str) -> dict:
    """A path of DENSE_PATHS, a few steps: each kernel counter must grow by
    exactly its launches per step (0 for the kernels the path does not
    run), the losses must be finite, and the model's bf16 eval output on
    the card must agree with a float32 CPU run of the same weights and
    BatchNorm statistics at B = SEG_REF_B within LOGIT_TOL of its largest
    value. Returns the counts of the kernels that ran, keyed
    `<kernel>_<tag>`."""
    what, build, _, _, per_step = DENSE_PATHS[tag]
    model, optimizer, full_step, img_u8, targets, gen = dense_setup(tag)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    losses = []
    n_steps = SEG_WARMUP_STEPS + SEG_TIMED_STEPS
    for step in range(n_steps):
        if step == SEG_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(full_step(model, optimizer, img_u8, targets,
                                gen)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ran = check_launches(tag, {name: n * n_steps
                               for name, n in per_step.items()})
    launches = {f"{name}_{tag}": n for name, n in ran.items()}
    losses = [float(x) for x in losses]
    print(f"[{tag}] losses: {losses}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    print(f"[{tag}] {what}, B={SEG_B}, bf16 compute / f32 AdamW, aug on "
          f"device: {dt / SEG_TIMED_STEPS * 1e3:.2f} ms/step, "
          f"{SEG_B * SEG_TIMED_STEPS / dt:.1f} img/s (mean of "
          f"{SEG_TIMED_STEPS} steps after {SEG_WARMUP_STEPS} warm-up), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"[{card}]", flush=True)

    x = eval_batch(img_u8[:SEG_REF_B])
    model.eval()
    with torch.no_grad():
        out = model(x).float().cpu()
        ref_model = build(torch.float32, "cpu")
        ref_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        ref = ref_model.eval()(x.cpu())
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad {tag} output {tuple(out.shape)}")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[{tag}] eval output {tuple(out.shape)} bf16 on card vs f32 on "
          f"CPU (B={SEG_REF_B}): max|err|={err:.4g}, max|ref|={scale:.4g}",
          flush=True)
    if err > LOGIT_TOL * scale:
        raise AssertionError(f"{tag} output disagrees: {err} > {LOGIT_TOL} "
                             f"* {scale}")
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


MLP_MODES = ("(a) x.W1^T + b1", "(b) gelu(h).W2^T + b2")


def mlp_n_tile(n: int) -> int:
    """The forward's N tile for output width n (`csrc/fused_mlp.cu`)."""
    return next(bn for bn in (256, 192, 128) if n % bn == 0)


def mlp_product(mode: int, bn: int, a, b, bias, out, m: int, n: int,
                k: int):
    """One product of the fused MLP's GEMM core alone, with N tile bn
    (`ssl4gie_mlp_gemm`, forward modes): out = a.b^T + bias (mode 0) or
    gelu(a).b^T + bias (mode 1), tanh GELU. Not counted: a measurement."""
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: _build.launch(
        "ssl4gie_mlp_gemm", mode, bn, a.data_ptr(), b.data_ptr(),
        bias.data_ptr(), out.data_ptr(), m, n, k, 1, stream)


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
        b2b_ms = cuda_ms_b2b(lambda: fm.mlp_fwd(*args))
        plain_ms = cuda_ms(lambda: fm.mlp_fwd_plain(*args))
        unfused = lambda x_, w1_, b1_, w2_, b2_: F.linear(F.gelu(
            F.linear(x_, w1_, b1_), approximate="tanh"), w2_, b2_)
        unfused_ms = cuda_ms(lambda: unfused(x, w1, b1, w2, b2))
        unfused_b2b_ms = cuda_ms_b2b(lambda: unfused(x, w1, b1, w2, b2))
        w_bytes = (2 * c * hd + c + hd) * 2
        # each product alone: (a) and (b) at the N tiles the entry point
        # picks, and (b) at the other tile that divides C
        bn_a, bn_b = mlp_n_tile(hd), mlp_n_tile(c)
        alt_b = 192 if c % 192 == 0 and bn_b != 192 else 128
        h_v, y_v = torch.empty_like(h_k), torch.empty_like(y_k)
        products = {}
        for mode, bn, a, b, bias, out, n, k in (
                (0, bn_a, x, w1, b1, h_v, hd, c),
                (1, bn_b, h_k, w2, b2, y_v, c, hd),
                (1, alt_b, h_k, w2, b2, y_v, c, hd)):
            run = mlp_product(mode, bn, a, b, bias, out, m, n, k)
            run()
            torch.cuda.synchronize()
            check_close(f"mlp product {mode} N tile {bn} {where}", out,
                        h_k if mode == 0 else y_k, tol)
            products[f"{'ab'[mode]}_n{bn}"] = cuda_ms_b2b(run)
        del h_v, y_v
        results.append(result(
            f"fused_mlp_fwd_{where}", "fused_mlp.cu",
            "ssl4gie_tpu/kernels/fused_mlp.py:75", err, ms, plain_ms, None,
            4 * m * c * hd, (2 * m * c + m * hd) * 2 + w_bytes,
            unfused_ms=unfused_ms, b2b_ms=b2b_ms,
            unfused_b2b_ms=unfused_b2b_ms, products_b2b_ms=products))
        half = 2 * m * c * hd
        print(f"[kernel] fused MLP fwd {where} ({m} x {c} -> {hd}) bf16: "
              f"max|err|={err:.3g} (tol {tol:.3g} rel) kernel {ms:.4f} ms "
              f"({tflops(2 * half, ms)}; back to back {b2b_ms:.4f} ms, "
              f"{tflops(2 * half, b2b_ms)}), plain {plain_ms:.4f} ms, unfused "
              f"cuBLAS {unfused_ms:.4f} ms ({tflops(2 * half, unfused_ms)}; "
              f"back to back {unfused_b2b_ms:.4f} ms), "
              f"bound {results[-1]['bound_ms']:.4f} ms  [{card}]", flush=True)
        print(f"[kernel] fused MLP fwd {where} products alone, back to "
              f"back: " + ", ".join(
            f"{MLP_MODES['ab'.index(key[0])]} N tile {key[3:]}: {t:.4f} ms "
            f"({tflops(half, t)})" for key, t in products.items()),
            flush=True)

        dh_k, g_k = fm.mlp_bwd(h_k, dy, w2.t())
        torch.cuda.synchronize()
        dh_p, g_p = fm.mlp_bwd_plain(h_k, dy, w2.t())
        err = max(check_close(f"mlp_bwd {where} dh", dh_k, dh_p, tol),
                  check_close(f"mlp_bwd {where} g", g_k, g_p, tol))
        del dh_p, g_p, dh_k, g_k
        ms = cuda_ms(lambda: fm.mlp_bwd(h_k, dy, w2.t()))
        b2b_ms = cuda_ms_b2b(lambda: fm.mlp_bwd(h_k, dy, w2.t()))
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
            unfused_ms=unfused_ms, fused_bwd_ms=fused_bwd_ms, b2b_ms=b2b_ms))
        print(f"[kernel] fused MLP bwd {where}: max|err|={err:.3g} (tol "
              f"{tol:.3g} rel) kernel {ms:.4f} ms ({tflops(2 * m * c * hd, ms)}"
              f", {results[-1]['bound_ms'] / ms:.3f} of the bound; back to "
              f"back {b2b_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, "
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


def attention_rows(tag: str, seqs: int, heads: int, dh: int,
                   card: str) -> list[dict]:
    """#1 and #2 at (seqs, TOKENS, 3 * heads * dh) against their plain
    versions, the forward also through `fused_qkv_attention` under
    no_grad (the momentum encoder's route); rows named
    `dense_attention_{fwd,bwd}_<tag>`."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    C, scale, tol = heads * dh, dh ** -0.5, 2.0 ** -6
    qkv = torch.randn((seqs, TOKENS, 3 * C), generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn((seqs, TOKENS, C), generator=gen, device=dev).to(
        torch.bfloat16)
    out_k, lse_k = da.attention_fwd(qkv, heads, scale)
    with torch.no_grad():
        out_ng = da.fused_qkv_attention(qkv, heads, scale)
    dq_k = da.attention_bwd(qkv, out_k, lse_k, dout, heads, scale)
    torch.cuda.synchronize()
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, scale)
    err_f = max(check_close(f"attention_fwd {tag}", out_k, out_p, tol),
                check_close(f"attention_fwd {tag} no_grad", out_ng, out_p,
                            tol))
    check_close(f"attention_fwd {tag} lse", lse_k, lse_p, 2.0 ** -16)
    err_b = check_close(f"attention_bwd {tag}", dq_k,
                        da.fused_qkv_attention_bwd_plain(qkv, dout, heads,
                                                         scale), tol)
    del out_p, lse_p, out_ng
    q, k, v = heads_of(qkv, heads)
    fwd = result(
        f"dense_attention_fwd_{tag}", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:146", err_f,
        cuda_ms(lambda: da.attention_fwd(qkv, heads, scale)),
        cuda_ms(lambda: da.fused_qkv_attention_plain(qkv, heads, scale)),
        sdpa_ms(q, k, v, scale), *attn_work(seqs, heads, TOKENS, dh, False))
    x = qkv.detach().requires_grad_(True)
    o = da.fused_qkv_attention_plain(x, heads, scale)
    work = attn_work(seqs, heads, TOKENS, dh, True)
    bwd = result(
        f"dense_attention_bwd_{tag}", "dense_attention.cu",
        "ssl4gie_tpu/kernels/dense_attention.py:169", err_b,
        cuda_ms(lambda: da.attention_bwd(qkv, out_k, lse_k, dout, heads,
                                         scale)),
        cuda_ms(lambda: torch.autograd.grad(o, x, dout, retain_graph=True)),
        sdpa_ms(q, k, v, scale, split_heads(dout, heads)), *work)
    del x, o
    print(f"[kernel] attention fwd / bwd  B={seqs} N={TOKENS} H={heads} "
          f"Dh={dh} bf16 ({tag}; the forward also under no_grad): max|err| "
          f"{err_f:.3g} / {err_b:.3g} (tol {tol:.3g} rel); kernel "
          f"{fwd['ms']:.4f} / {bwd['ms']:.4f} ms ({tflops(work[0], bwd['ms'])}"
          f" bwd), plain {fwd['plain_ms']:.4f} / {bwd['plain_ms']:.4f} ms, "
          f"sdpa {fwd['library_ms']:.4f} / {bwd['library_ms']:.4f} ms, bound "
          f"{fwd['bound_ms']:.4f} / {bwd['bound_ms']:.4f} ms  [{card}]",
          flush=True)
    return [fwd, bwd]


def moco_kernel_phase(card: str) -> list[dict]:
    """#1/#2 at the MoCo path's shapes: B = MOCO_B images of 197 tokens,
    ViT-B's 12 x 64 (vit_b, vit_conv_b) and ViT-S's 12 x 32 (vit_s)."""
    rows = []
    for arch in ("vit_b", "vit_s"):
        preset = VIT_PRESETS[arch]
        rows += attention_rows(f"moco_{arch}", MOCO_B, preset["num_heads"],
                               preset["embed_dim"] // preset["num_heads"],
                               card)
    # vit_conv_b runs the same shapes as vit_b: its rows repeat those times
    rows += [dict(r, name=r["name"].replace("vit_b", "vit_conv_b"))
             for r in rows[:2]]
    return rows


MAE_COUNTERS = {"fused_mlp_fwd": fm.mlp_fwd, "fused_mlp_bwd": fm.mlp_bwd,
                "dense_attention_fwd_dh32": da.attention_fwd,
                "dense_attention_bwd_dh32": da.attention_bwd}


def mae_setup():
    """The full-width MAE ViT-B (random weights from SEED, bf16 compute over
    f32 masters), its optimizer, the full step, a synthetic uint8 batch of
    256 px canvases on the card and a generator."""
    dev = torch.device("cuda")
    cfg = PretrainConfig(batch_size=MAE_B)
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



def pretrain_config(framework: str, arch: str, ckpt_dir: str,
                    synthetic_size: int, argv=()) -> PretrainConfig:
    """The PretrainConfig `cli/pretrain.py` makes for `framework` on `arch`
    at B = MOCO_B on `synthetic_size` synthetic canvases (the recipe's
    optimizer, learning rate and weight decay), plus `argv`."""
    p = cli_pretrain.build_parser()
    cfg = cli_pretrain.to_pretrain_config(p, p.parse_args(
        ["--framework", framework, "--arch", arch, "--synthetic",
         "--batch-size", str(MOCO_B), "--ckpt-dir", ckpt_dir, *argv]))
    cfg.data.synthetic_size = synthetic_size
    return cfg


def moco_steps_per_kernel(run) -> dict:
    """A MoCo step's launches: per view, the momentum encoder's forward and
    the encoder's forward and backward in every block of a ViT; none for
    RN50."""
    if run.cfg.architecture == Architecture.RESNET50:
        return {}
    depth = len(run.model.encoder.backbone.blocks)
    return {"dense_attention_fwd": 4 * depth,
            "dense_attention_bwd": 2 * depth}


def moco_path(arch: str, card: str) -> dict:
    """The full-width MoCo v3 step on `arch` (dim 256, mlp_dim 4096, bf16
    over f32 masters; vit_b AdamW with its patch projection frozen, RN50
    LARS), built by `build_pretraining` from the CLI's config, on one
    resident batch of MOCO_B 256 px canvases, a few times. Checks each
    kernel counter's growth, finite losses and gradient norms, the frozen
    patch projection bitwise unchanged in both encoders, the last step's
    momentum parameters against m * old + (1 - m) * encoder, and the bf16
    projector output against a float32 CPU run of the same weights and
    statistics. Returns the launch counts keyed `<kernel>_moco_<arch>`."""
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ssl4gie_moco_") as tmp:
        run = build_pretraining(pretrain_config("mocov3", arch, tmp,
                                                MOCO_B))
    model, optimizer = run.model, run.optimizer
    total_steps = len(run.loader) * run.cfg.epochs
    src = SyntheticUnlabeled(MOCO_B, canvas=MOCO_CANVAS, seed=SEED)
    img_u8 = torch.from_numpy(src.batch(range(MOCO_B))["image"]).to(dev)
    gen = torch.Generator().manual_seed(SEED)
    vit, frozen = arch in VIT_PRESETS, arch in STOP_GRAD_ARCHS
    pe0 = ([p.detach().clone() for p in model.patch_embed_parameters()]
           if vit else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    hist = []
    n_steps = MOCO_WARMUP_STEPS + MOCO_TIMED_STEPS
    for step in range(n_steps):
        if step == MOCO_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        hist.append(run.full_step(model, optimizer, img_u8, gen, step))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tag = f"moco_{arch}"
    ran = check_launches(tag, {k: n * n_steps for k, n in
                               moco_steps_per_kernel(run).items()})
    hist = [{k: float(v) for k, v in h.items()} for h in hist]
    print(f"[{tag}] loss / grad_norm: {hist}", flush=True)
    if not all(np.isfinite(list(h.values())).all() for h in hist):
        raise AssertionError(f"non-finite MoCo loss or gradient norm: {hist}")
    ms_step = dt / MOCO_TIMED_STEPS * 1e3
    print(f"[{tag}] MoCo v3 {arch} 224 px step (two views, momentum "
          f"encoder, {run.cfg.optimizer}), B={MOCO_B}, bf16 compute / f32 "
          f"masters, moco_two_crops on device: {ms_step:.2f} ms/step, "
          f"{MOCO_B * MOCO_TIMED_STEPS / dt:.1f} img/s (mean of "
          f"{MOCO_TIMED_STEPS} steps after {MOCO_WARMUP_STEPS} warm-up), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"[{card}]", flush=True)

    # one more step: its EMA against m * old + (1 - m) * encoder, recomputed
    old = [p.detach().clone() for p in model.momentum_encoder.parameters()]
    enc = [p.detach().clone() for p in model.encoder.parameters()]
    run.full_step(model, optimizer, img_u8, gen, n_steps)
    m = cosine_momentum(n_steps, base_m=run.cfg.moco_momentum,
                        total_steps=total_steps)
    err = max(check_close(f"{tag} momentum", p.detach(), o * m + e * (1 - m),
                          2.0 ** -22)
              for p, o, e in zip(model.momentum_encoder.parameters(), old,
                                 enc))
    del old, enc
    stem = "no patch projection (RN50)"
    if vit:
        mom_pe = model.momentum_encoder.backbone.patch_embed.parameters()
        same = [torch.equal(a, b) and (not frozen or torch.equal(c, b))
                for a, b, c in zip(model.patch_embed_parameters(), pe0,
                                   mom_pe)]
        if frozen != all(same):
            raise AssertionError(f"{tag}: the patch projection "
                                 f"{'moved' if frozen else 'did not move'}")
        stem = ("patch projection frozen: bitwise unchanged in both "
                "encoders" if frozen else "conv stem trained: moved")
    print(f"[{tag}] momentum parameters vs m * old + (1 - m) * encoder "
          f"(m = {m:.9g}): max|err| {err:.3g}; {stem}", flush=True)

    # the bf16 projector output on the card against a float32 CPU run of the
    # same weights and running statistics (eval mode)
    x = moco_two_crops(img_u8[:MOCO_REF_B], sample_moco_params(
        MOCO_REF_B, gen, MOCO_CANVAS))[0]
    model.encoder.eval()
    with torch.no_grad():
        out = model.encoder(x).float().cpu()
        ref_enc = MoCoEncoder(arch, run.cfg.moco_dim, run.cfg.moco_mlp_dim)
        ref_enc.load_state_dict({k: v.cpu() for k, v in
                                 model.encoder.state_dict().items()})
        ref = ref_enc.eval()(x.cpu())
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[{tag}] projector output {tuple(out.shape)} bf16 on card vs f32 "
          f"on CPU (B={MOCO_REF_B}): max|err|={err:.4g}, max|ref|={scale:.4g}",
          flush=True)
    if not bool(torch.isfinite(out).all()) or err > LOGIT_TOL * scale:
        raise AssertionError(f"{tag} projector output disagrees: {err} > "
                             f"{LOGIT_TOL} * {scale}")
    MOCO_MS_STEP[arch] = ms_step
    return {f"{name}_{tag}": n for name, n in ran.items()}


DET_COUNTERS = {"window_attention_fwd": wa.window_attention_fwd,
                "window_attention_bwd": wa.window_attention_bwd,
                "flash_attention_fwd": fa.flash_fwd,
                "flash_attention_bwd": fa.flash_bwd}


def det_setup(arch: str = "vit_b", canvas: int = DET_IMG):
    """The full-width detector `arch` on a `canvas` px square (random
    weights from SEED), its optimizer, the full step, a synthetic uint8
    batch on the card and a generator."""
    dev = torch.device("cuda")
    model = FasterRCNN(arch=arch, image_size=canvas, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED),
                       device=dev)
    src = SyntheticDetectionSource(DET_B, canvas=canvas, seed=SEED)
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


def det_rn50_path(card: str) -> dict:
    """The full-width RN50-FPN Faster R-CNN train step at TV_CANVAS px, a
    few times: no kernel launches, finite losses, the body's BatchNorm
    running statistics bitwise unchanged (frozen, as torchvision's
    FrozenBatchNorm2d), and the bf16 FPN maps against a float32 CPU run of
    the same weights on a small input."""
    model, optimizer, full_step, batch, gen = det_setup("resnet50",
                                                        TV_CANVAS)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running_" in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
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
    check_launches("det_rn50", {})
    losses = [{k: float(v) for k, v in d.items()} for d in losses]
    print(f"[det_rn50] losses: {losses}", flush=True)
    if not all(np.isfinite(list(d.values())).all() for d in losses):
        raise AssertionError(f"non-finite detection loss: {losses}")
    after = model.state_dict()
    moved = [k for k, v in stats.items() if not torch.equal(after[k], v)]
    print(f"[det_rn50] {len(stats)} BatchNorm running statistics, "
          f"{len(moved)} moved over {n_steps} steps", flush=True)
    if moved:
        raise AssertionError(f"frozen BatchNorm statistics moved: {moved}")
    print(f"[det_rn50] RN50-FPN Faster R-CNN {TV_CANVAS} px train step, "
          f"B={DET_B}, bf16 compute / f32 AdamW, detection_augment on "
          f"device: {dt / DET_TIMED_STEPS * 1e3:.2f} ms/step, "
          f"{DET_B * DET_TIMED_STEPS / dt:.2f} img/s (mean of "
          f"{DET_TIMED_STEPS} steps after {DET_WARMUP_STEPS} warm-up), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"[{card}]", flush=True)

    # the FPN maps, bf16 on the card against f32 on the CPU, small input
    x = normalize(batch["image"][:RN50_DET_REF_B, :RN50_DET_REF_IMG,
                                 :RN50_DET_REF_IMG].to(torch.float32) / 255.0)
    ref_model = FasterRCNN(arch="resnet50", image_size=RN50_DET_REF_IMG,
                           dtype=torch.float32, device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in after.items()})
    model.eval()
    with torch.no_grad():
        maps = [m.float().cpu() for m in model.backbone(x.to(torch.bfloat16))]
        refs = ref_model.eval().backbone(x.cpu())
    for lvl, (m, r) in enumerate(zip(maps, refs)):
        err, scale = (m - r).abs().max().item(), r.abs().max().item()
        print(f"[det_rn50] FPN level {lvl} {tuple(m.shape)} bf16 on card vs "
              f"f32 on CPU: max|err|={err:.4g}, max|ref|={scale:.4g}",
              flush=True)
        if m.shape != r.shape or not bool(torch.isfinite(m).all()) \
                or err > LOGIT_TOL * scale:
            raise AssertionError(f"FPN level {lvl} disagrees: {err} > "
                                 f"{LOGIT_TOL} * {scale}")
    return {}


class FrameSource(DetectionSource):
    """A `DetectionSource` whose frames are made, not read: random uint8
    frames of `sizes` (w, h) with one to three painted boxes each, from
    SEED. The placement (resize, canvas, boxes, content size) is the
    source's own."""

    def __init__(self, sizes, canvas: int, resize: str):
        super().__init__([f"frame{i}" for i in range(len(sizes))], {},
                         canvas, resize=resize)
        self.sizes = sizes

    def decode(self, i):
        rng = np.random.default_rng(SEED * 7919 + i)
        w, h = self.sizes[i]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(1, 4))
        xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.35, (n, 2)) * (w, h)
        boxes = np.concatenate([xy, np.minimum(xy + wh, (w, h))],
                               axis=1).astype(np.float32)
        for x0, y0, x1, y1 in boxes.astype(int):
            img[y0:y1, x0:x1] = rng.integers(180, 256, 3)
        return img, boxes, np.ones((n,), np.int32)


def det_eval_path(card: str) -> dict:
    """`evaluate_map` at batch EVAL_B over five frames (the tail padded) for
    both detectors at full width: the RN50 at TV_CANVAS px with
    torchvision placement (content sizes below the canvas: the batch-max
    emulation works), which launches no kernel, and the ViT-B at DET_IMG
    px with fixed placement, exactly 8 window and 4 flash forwards a batch
    and nothing else. Each after a one-batch warm-up; the mAP dict must be
    finite (random weights: its value means nothing). Returns the ViT's
    window and flash launch counts."""
    dev = torch.device("cuda")
    n_batches = -(-len(RN50_EVAL_FRAMES) // EVAL_B)
    out = {}
    for arch, canvas, frames, resize in (
            ("resnet50", TV_CANVAS, RN50_EVAL_FRAMES, "torchvision"),
            ("vit_b", DET_IMG, VIT_EVAL_FRAMES, "fixed")):
        tag = f"det_eval {arch}"
        model = FasterRCNN(arch=arch, image_size=canvas, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev)
        src = FrameSource(frames, canvas, resize)
        if arch == "resnet50":
            sizes = tuple(tuple(src.get(i)["content_size"].tolist())
                          for i in range(len(src)))
            print(f"[{tag}] content sizes {sizes}", flush=True)
            if sizes != RN50_EVAL_CONTENT:
                raise AssertionError(f"content sizes {sizes} != "
                                     f"{RN50_EVAL_CONTENT}")
        evaluate_map(model, FrameSource(frames[:EVAL_B], canvas, resize),
                     EVAL_B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = evaluate_map(model, src, EVAL_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if arch == "resnet50":
            check_launches(tag, {})
        else:
            out = check_launches(tag, {
                "window_attention_fwd": 8 * n_batches,
                "flash_attention_fwd": 4 * n_batches})
        print(f"[{tag}] mAP {res}", flush=True)
        if set(res) != {"map", "map_50", "map_75"} or \
                not np.isfinite(list(res.values())).all():
            raise AssertionError(f"bad mAP dict: {res}")
        print(f"[{tag}] evaluate_map {canvas} px, {len(src)} frames at "
              f"batch {EVAL_B} ({resize} placement; host decode and "
              f"placement included): {dt / n_batches * 1e3:.2f} ms per eval "
              f"batch, {len(src) / dt:.2f} img/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
              f"[{card}]", flush=True)
        del model
    return {f"{name}_eval": n for name, n in out.items()}


# harness -> (module, B, L): the harnesses' full sizes
HARNESSES = {"attention": (bak, 128, 12), "window": (bwk, 2, 8)}


def hold_leg(what: str, leg, x0: torch.Tensor, dout: torch.Tensor) -> float:
    """One layer of a harness leg on the card (through its autograd path,
    at the leg's configuration) against its kernels' plain versions on the
    same input: the output and the gradient within 2^-6."""
    x = x0.detach().requires_grad_(True)
    out = leg.layer(x)
    (g,) = torch.autograd.grad(out, x, dout)
    ref_out, ref_g = leg.plain(x0, dout)
    return max(check_close(f"{what} forward", out, ref_out, 2.0 ** -6),
               check_close(f"{what} gradient", g, ref_g, 2.0 ** -6))


def harness_path(card: str) -> dict:
    """Every leg of both kernel A/B harnesses at full size: one layer of
    each kernel leg against the plain versions on the harness's own input,
    then a few timed steps. Returns the variants' launch counts by JSON
    name."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    watched = {fn for mod, _, _ in HARNESSES.values()
               for leg in mod.LEGS.values() for fn, _ in leg.kernels}
    names = lambda counts: {fn.__name__: n for fn, n in counts.items()}
    launches, ms = collections.Counter(), {}
    for name, (mod, batch, depth) in HARNESSES.items():
        x0 = mod.make_x0(batch, dev)
        dout = torch.randn(x0.shape[:-1] + (x0.shape[-1] // 3,),
                           generator=gen, device=dev).to(x0.dtype)
        for leg_name, leg in mod.LEGS.items():
            if leg.plain is not None:
                err = hold_leg(f"{name} {leg_name}", leg, x0, dout)
                print(f"[harness] {name} {leg_name}: one layer at B={batch} "
                      f"against the plain versions, max|err|={err:.3g} "
                      f"(tol {2.0 ** -6:.3g} rel)", flush=True)
            before = {fn: fn.launches for fn in watched}
            res = mod.bench(leg_name, x0, depth, HARNESS_TIMED_STEPS, card,
                            warmup=HARNESS_WARMUP_STEPS)
            moved = {fn: fn.launches - before[fn] for fn in watched
                     if fn.launches != before[fn]}
            want = {fn: depth * res["steps_run"] for fn, _ in leg.kernels}
            print(f"[harness] {name} {leg_name}: launches {names(moved)} "
                  f"(expected {names(want)}), losses {res['losses']}",
                  flush=True)
            if moved != want:
                raise AssertionError(
                    f"the {name} harness's {leg_name} leg did not run "
                    f"through its kernels: {names(moved)} != {names(want)}")
            if not np.isfinite(res["losses"]).all():
                raise AssertionError(f"non-finite {name} {leg_name} loss: "
                                     f"{res['losses']}")
            for fn, config in leg.kernels:
                if config is not None:
                    launches[entry_name(fn, config)] += moved[fn]
            ms[f"{name}.{leg_name}"] = res["ms_step"]
        del x0, dout
    ratio = lambda a, b: ms[a] / ms[b]
    print(f"[harness] ms/step ratios: v2/fused "
          f"{ratio('attention.v2', 'attention.fused'):.3f}, v3/v2 "
          f"{ratio('attention.v3', 'attention.v2'):.3f}, v4/fused "
          f"{ratio('attention.v4', 'attention.fused'):.3f}, window v2 G1 / G2 "
          f"/ G4 vs current {ratio('window.v2', 'window.current'):.3f} / "
          f"{ratio('window.v2g2', 'window.current'):.3f} / "
          f"{ratio('window.v2g4', 'window.current'):.3f}  [{card}]",
          flush=True)
    print(f"[harness] {json.dumps(ms)}", flush=True)
    return dict(launches)


# The finetune driver, as a user runs it (`cli/train.py`'s argv): ViT-B/16
# classification at full width, B = 64, over a synthetic split of 320
# images (5 train steps, 5 val and 5 test batches an epoch)
DRIVER_ARGV = ["--task", "classification", "--architecture", "vit_b",
               "--synthetic", "--batch-size", "64"]     # cli.evaluate's too
DRIVER_SYNTHETIC = 320
# the JAX Trainer's ledger payloads (`ssl4gie_tpu/core/trainer.py`), each
# with the logger's wall_s; the last train step of an epoch adds max_mem_mb
DRIVER_LEDGER_KEYS = [
    {"epoch", "step", "loss", "lr", "images_per_sec", "step_time_ms",
     "eta_s", "max_mem_mb", "wall_s"},
    {"epoch", "val_perf", "wall_s"}, {"epoch", "test_perf", "wall_s"},
    {"epoch", "new_best_val", "test_at_best", "wall_s"},
    {"epoch", "lr_reduced_to", "wall_s"},
    {"resumed_from_epoch", "best_val", "wall_s"}]


def driver_config(ckpt_dir: str, epochs: int):
    """The port's TrainConfig of DRIVER_ARGV, as `cli/train.py` makes it."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        DRIVER_ARGV + ["--learning-rate-scheduler", "--epochs", str(epochs),
                       "--ckpt-dir", ckpt_dir]))
    cfg.data.synthetic_size = DRIVER_SYNTHETIC
    return cfg


def timed(obj, name: str, into: list) -> None:
    """Wrap the method `name` of `obj` so that each call appends its ms
    (host clock, the device synchronized before and after) to `into`."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapper)


def bare_cls_ms() -> float:
    """The bare classification step (cls_setup's full step on one resident
    batch), ms/step: the yardstick of the driver's step time."""
    model, optimizer, full_step, img_u8, labels, aug_gen = cls_setup()
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        if step == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        full_step(model, optimizer, img_u8, labels, aug_gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TIMED_STEPS * 1e3


def _equal_states(a, b, what: str) -> None:
    """Raise unless the two (nested) states are bitwise equal."""
    if torch.is_tensor(a):
        if not torch.equal(a, b.to(a.device)):
            raise AssertionError(f"{what}: restored state differs")
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _equal_states(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _equal_states(x, y, f"{what}[{i}]")
    elif a != b:
        raise AssertionError(f"{what}: {a} != {b}")


def driver_path(card: str) -> dict:
    """The finetune driver at full width through its entry points:
    `build_trainer` on DRIVER_ARGV, `fit()` for two epochs; the run's end
    state written as the requeue slot of a three-epoch run preempted after
    its second epoch (what `Trainer._check_preempted` saves at that
    boundary); a second `build_trainer` with --epochs 3 that resumes at
    epoch 3 whichever epoch won on val, and runs it; then
    `cli.evaluate.main` on the best-val slot. Checks the kernels' launches
    (12 + 12 + 1 per train step, 12 forwards per eval batch, nothing
    else), finite losses, the restored state bitwise, the ledger's keys and
    the printed metrics; prints the driver's step time beside the bare
    step's, the Loader's rate, the eval, snapshot, save and load times, the
    checkpoint's size and peak memory. Returns the launch counts keyed
    `<kernel>_driver`."""
    bare_ms = bare_cls_ms()
    with tempfile.TemporaryDirectory(prefix="ssl4gie_driver_") as tmp:
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(driver_config(tmp, 2))
        depth = len(trainer.model.backbone.blocks)
        eval_ms, snap_ms, save_ms, load_ms = [], [], [], []
        timed(trainer, "evaluate", eval_ms)
        timed(trainer, "_ckpt_tree", snap_ms)
        timed(trainer.ckpt, "save", save_ms)
        trainer.fit()
        trainer.preempt_ckpt.save(trainer._ckpt_tree(2, trainer.best_val,
                                                     0.0))
        size = os.path.getsize(trainer.ckpt.path)

        resumed = build_trainer(driver_config(tmp, 3))
        timed(resumed, "maybe_resume", load_ms)
        resume = resumed.maybe_resume

        def resume_and_check():
            resume()
            _equal_states(resumed.model.state_dict(),
                          trainer.model.state_dict(), "model")
            _equal_states(resumed.optimizer.state_dict(),
                          trainer.optimizer.state_dict(), "optimizer")

        resumed.maybe_resume = resume_and_check
        timed(resumed, "evaluate", eval_ms)
        resumed.fit()
        if resumed.start_epoch != 3 or resumed.preempt_ckpt.exists():
            raise AssertionError(f"resumed at epoch {resumed.start_epoch}, "
                                 "expected 3 (and the stale requeue slot "
                                 "deleted)")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results = cli_evaluate.main(
                DRIVER_ARGV + ["--ckpt-dir", tmp, "--results-root", tmp])
        print(out.getvalue(), end="", flush=True)
        for key in ("mF1:", "mPrecision:", "mRecall:", "Accuracy:"):
            if key not in out.getvalue():
                raise AssertionError(f"cli.evaluate printed no {key}")
        if not all(np.isfinite(list(results.values()))):
            raise AssertionError(f"non-finite eval results {results}")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30

        ledger = [json.loads(ln) for ln in
                  Path(trainer.logger.jsonl_path).read_text().splitlines()]
        n_cli = -(-DataConfig().synthetic_size
                  // trainer.val_loader.batch_size)
        loader = trainer.train_loader
        t0 = time.perf_counter()
        n_loader = sum(1 for _ in loader.epoch(99))
        loader_s = time.perf_counter() - t0

    steps = 3 * len(trainer.train_loader)
    evals = 3 * (len(trainer.val_loader) + len(trainer.test_loader)) + n_cli
    ran = check_launches("driver", {
        "dense_attention_fwd": depth * (steps + evals),
        "dense_attention_bwd": depth * steps, "shear_rotate": steps})
    train_lines = [p for p in ledger if "step" in p]
    losses = [p["loss"] for p in train_lines]
    if len(train_lines) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"driver losses {losses}")
    for p in ledger:
        if set(p) not in DRIVER_LEDGER_KEYS:
            raise AssertionError(f"ledger payload {sorted(p)} is not one "
                                 "of the JAX Trainer's")
    batch = trainer.train_loader.batch_size
    eval_batches = len(trainer.val_loader)
    per_eval = [ms / eval_batches for ms in eval_ms]
    print(f"[driver] launches over {steps} train steps and {evals} eval "
          f"batches: {ran}", flush=True)
    for p in train_lines:
        print(f"[driver] epoch {p['epoch']}: step_time_ms "
              f"{p['step_time_ms']:.2f}, images_per_sec "
              f"{p['images_per_sec']:.1f} over {p['step']} steps (the "
              f"Loader's decode and the copies included), loss "
              f"{p['loss']:.4f}; the bare step {bare_ms:.2f} ms/step, "
              f"{batch / bare_ms * 1e3:.1f} img/s  [{card}]", flush=True)
    print(f"[driver] Loader alone: {n_loader / loader_s:.2f} batches/s "
          f"({n_loader} batches of {batch} synthetic 224 px images, "
          f"{DataConfig().num_workers} threads)  [{card}]", flush=True)
    print(f"[driver] eval: {statistics.median(per_eval):.2f} ms per batch of "
          f"{batch} (median of {len(per_eval)} passes of {eval_batches} "
          f"batches; passes {[round(x, 2) for x in per_eval]})  [{card}]",
          flush=True)
    print(f"[driver] host copies of the state (`_ckpt_tree`, in call order:"
          f" boundary 1, best 1, boundary 2, [best 2,] the requeue tree): "
          f"{[round(x, 1) for x in snap_ms]} ms; best-val save "
          f"(write + fsync + rename): {[round(x, 1) for x in save_ms]} ms; "
          f"checkpoint {size} bytes; resume load: "
          f"{[round(x, 1) for x in load_ms]} ms; peak memory {peak:.2f} "
          f"GiB  [{card}]", flush=True)
    return {f"{name}_driver": n for name, n in ran.items()}


# the pretraining driver: MoCo v3 vit_b and MAE vit_b at B = MOCO_B over a
# synthetic set of three batches (three steps an epoch)
PRETRAIN_SYNTHETIC = 3 * MOCO_B
# the JAX run_loop's ledger payloads, each with the logger's wall_s
PRETRAIN_LEDGER_KEYS = [
    {"epoch", "step", "loss", "grad_norm", "images_per_sec", "step_time_ms",
     "eta_s", "wall_s"},
    {"epoch", "max_mem_mb", "wall_s"}, {"resumed_from_epoch", "wall_s"}]


def pretrain_driver_path(card: str) -> dict:
    """The pretraining driver at full width through `cli/pretrain.py`'s
    config and `run`: MoCo v3 vit_b for two epochs with --keep-last 1; a
    second run with --epochs 3 that resumes from the `.resume` slot (its
    restored weights, momentum weights, BatchNorm statistics, AdamW state
    and step bitwise the first run's) and runs the third epoch; then one
    MAE vit_b epoch. Checks the kernels' launches per step (MoCo 48 + 24,
    MAE 8 + 8 at Dh 32, nothing else), finite losses, the ledger's keys and
    the slots left; prints the driver's ms/step beside the bare MoCo
    step's, the save and load times and the slots' sizes. Returns the
    launch counts keyed `<kernel>_pretrain`."""
    runs, save_ms, load_ms = [], [], []
    save, resume = PretrainRun.save, PretrainRun.maybe_resume

    def saving(self, epoch):
        runs.append(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, epoch)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    def resuming(self):
        t0 = time.perf_counter()
        resume(self)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        if self.start_epoch != 1:
            first = runs[-1]
            _equal_states(self.model.state_dict(), first.model.state_dict(),
                          "model")
            _equal_states(self.optimizer.state_dict(),
                          first.optimizer.state_dict(), "optimizer")
            if self.step != first.step:
                raise AssertionError(f"resumed at step {self.step}, saved "
                                     f"{first.step}")

    PretrainRun.save, PretrainRun.maybe_resume = saving, resuming
    try:
        with tempfile.TemporaryDirectory(prefix="ssl4gie_pretrain_") as tmp:
            for fn in COUNTERS.values():
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = PRETRAIN_SYNTHETIC // MOCO_B
            for fw, epochs, extra in (("mocov3", 2, ["--keep-last", "1"]),
                                      ("mocov3", 3, ["--keep-last", "1"]),
                                      ("mae", 1, [])):
                cfg = pretrain_config(fw, "vit_b", tmp, PRETRAIN_SYNTHETIC,
                                      ["--epochs", str(epochs), *extra])
                cfg.runtime.log_every = steps
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    cli_pretrain.run(cfg)
                print(out.getvalue(), end="", flush=True)
                if fw == "mocov3" and epochs == 3:
                    if not re.search(r"resuming MoCo pretraining at epoch 3",
                                     out.getvalue()):
                        raise AssertionError("the second run did not resume "
                                             "at epoch 3")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            slots = sorted(f for f in os.listdir(tmp) if f.endswith(".pt"))
            sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in slots}
            ledger = {fw: [json.loads(ln) for ln in Path(
                tmp, f"pretrain_{fw}_vit_b.jsonl").read_text().splitlines()]
                for fw in ("mocov3", "mae")}
    finally:
        PretrainRun.save, PretrainRun.maybe_resume = save, resume

    want_slots = ["checkpoint-0.pt", "checkpoint_0002.pt", "mae_vit_b.pt",
                  "mae_vit_b.resume.pt", "mocov3_vit_b.pt",
                  "mocov3_vit_b.resume.pt"]
    if slots != want_slots:
        raise AssertionError(f"slots {slots} != {want_slots}")
    depth = VIT_PRESETS["vit_b"]["depth"]
    moco_steps, mae_steps = 3 * steps, steps
    ran = check_launches("pretrain", {
        "dense_attention_fwd": 4 * depth * moco_steps + 8 * mae_steps,
        "dense_attention_bwd": 2 * depth * moco_steps + 8 * mae_steps})
    for fw, lines in ledger.items():
        for p in lines:
            if set(p) not in PRETRAIN_LEDGER_KEYS:
                raise AssertionError(f"{fw} ledger payload {sorted(p)} is "
                                     "not one of the JAX loop's")
        train = [p for p in lines if "step" in p]
        if not all(np.isfinite([p["loss"], p["grad_norm"]]).all()
                   for p in train):
            raise AssertionError(f"{fw} driver losses {train}")
        for p in train:
            bare = (f"; the bare MoCo step {MOCO_MS_STEP['vit_b']:.2f} "
                    "ms/step" if fw == "mocov3" else "")
            print(f"[pretrain] {fw} epoch {p['epoch']}: step_time_ms "
                  f"{p['step_time_ms']:.2f}, images_per_sec "
                  f"{p['images_per_sec']:.1f} over {p['step']} steps (the "
                  f"Loader's decode and the copies included), loss "
                  f"{p['loss']:.4f}, grad_norm {p['grad_norm']:.4g}{bare}  "
                  f"[{card}]", flush=True)
    print(f"[pretrain] launches over {moco_steps} MoCo and {mae_steps} MAE "
          f"steps: {ran}; saves (host copy, export, resume and retained "
          f"slots, in epoch order: MoCo 1, 2, 3, MAE 1) "
          f"{[round(x, 1) for x in save_ms]} ms; resume loads "
          f"{[round(x, 1) for x in load_ms]} ms; slot bytes {sizes}; peak "
          f"memory {peak:.2f} GiB  [{card}]", flush=True)
    return {f"{name}_pretrain": n for name, n in ran.items()}


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


def profile_dense(tag: str, card: str, out_dir: str) -> None:
    """torch.profiler over SEG_TIMED_STEPS steps of a DENSE_PATHS path;
    also prints the device time of layout conversions around the
    convolutions (cuDNN's NCHW <-> NHWC and tensor-transform kernels),
    which channels-last maps should not need."""
    model, optimizer, full_step, img_u8, targets, gen = dense_setup(tag)
    events, _ = profile_steps(
        card, lambda: full_step(model, optimizer, img_u8, targets, gen),
        SEG_TIMED_STEPS, out_dir, f"{tag}_profile.txt")
    from torch.autograd import DeviceType
    layout = [e for e in events if e.device_type == DeviceType.CUDA
              and re.search(r"(?i)nchwtonhwc|nhwctonchw|tensortransform",
                            e.key)]
    ms = sum(e.self_device_time_total for e in layout) / 1e3 / SEG_TIMED_STEPS
    calls = sum(e.count for e in layout) // SEG_TIMED_STEPS
    print(f"[profile] {tag}: layout conversions (NCHW <-> NHWC, tensor "
          f"transforms) "
          f"{calls} a step, {ms:.3f} ms/step  [{card}]", flush=True)


def profile_moco(card: str, out_dir: str) -> None:
    """torch.profiler over MOCO_TIMED_STEPS MoCo v3 vit_b steps (the MoCo
    path's setup: one resident batch, the driver's full step)."""
    with tempfile.TemporaryDirectory(prefix="ssl4gie_moco_") as tmp:
        run = build_pretraining(pretrain_config("mocov3", "vit_b", tmp,
                                                MOCO_B))
    src = SyntheticUnlabeled(MOCO_B, canvas=MOCO_CANVAS, seed=SEED)
    img_u8 = torch.from_numpy(src.batch(range(MOCO_B))["image"]).cuda()
    gen = torch.Generator().manual_seed(SEED)
    profile_steps(card, lambda: run.full_step(run.model, run.optimizer,
                                              img_u8, gen, 1),
                  MOCO_TIMED_STEPS, out_dir, "moco_vit_b_profile.txt")


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


def print_nms_span(what: str, events, wall: float, n_steps: int,
                   card: str) -> None:
    """The "nms_topk" range on the device timeline, per step: first to
    last kernel of the NMS slot loops, idle gaps included."""
    nms = [e for e in events if e.key == "nms_topk"]
    nms_ms = max((e.device_time_total for e in nms), default=0) / 1e3 / \
        n_steps
    print(f"[profile] {what}: nms_topk span {nms_ms:.2f} ms/step "
          f"({nms_ms / wall:.3f} of wall)  [{card}]", flush=True)


def profile_det_rn50(card: str, out_dir: str) -> None:
    """torch.profiler over DET_TIMED_STEPS RN50 detection steps."""
    model, optimizer, full_step, batch, gen = det_setup("resnet50",
                                                        TV_CANVAS)
    events, wall = profile_steps(
        card, lambda: full_step(model, optimizer, batch, gen),
        DET_TIMED_STEPS, out_dir, "det_rn50_profile.txt")
    print_nms_span("RN50 detection step", events, wall, DET_TIMED_STEPS,
                   card)


def profile_driver(card: str, out_dir: str) -> None:
    """torch.profiler over one epoch of the finetune driver (its "step" is
    the epoch: 5 train steps, the Loader's decode, the copies and the
    loss read) after one warm-up epoch."""
    with tempfile.TemporaryDirectory(prefix="ssl4gie_driver_") as tmp:
        trainer = build_trainer(driver_config(tmp, 2))
        epochs = iter((1, 2))
        profile_steps(card, lambda: trainer.train_epoch(next(epochs)), 1,
                      out_dir, "driver_epoch_profile.txt")


def profile_det_eval(card: str, out_dir: str) -> None:
    """torch.profiler over one ViT-B eval batch (EVAL_B frames placed as
    `evaluate_map` places them) after one warm-up batch."""
    model = FasterRCNN(image_size=DET_IMG, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED),
                       device=torch.device("cuda"))
    src = FrameSource(VIT_EVAL_FRAMES[:EVAL_B], DET_IMG, "fixed")
    imgs = torch.from_numpy(np.stack([src.get(i)["image"]
                                      for i in range(EVAL_B)])).cuda()
    eval_step = make_detection_eval_step(model)
    events, wall = profile_steps(
        card, lambda: eval_step(imgs.to(torch.float32) / 255.0), 1, out_dir,
        "det_eval_profile.txt")
    print_nms_span("ViT-B eval batch", events, wall, 1, card)


def profile_det(card: str, out_dir: str) -> None:
    """torch.profiler over DET_TIMED_STEPS detection steps after one warm-up:
    device time by kernel, the device's busy share, and the NMS slot loop's
    host time ("nms_topk" range); the table goes to out_dir."""
    from ssl4gie_tpu_torch.ops.nms import nms_topk
    model, optimizer, full_step, batch, gen = det_setup()
    events, wall = profile_steps(
        card, lambda: full_step(model, optimizer, batch, gen),
        DET_TIMED_STEPS, out_dir, "det_profile.txt")
    print_nms_span("detection step", events, wall, DET_TIMED_STEPS, card)
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
                        help="also profile the classification, "
                             "segmentation, RN50 segmentation, ViT depth, "
                             "ViT and RN50 detection, MAE and MoCo vit_b "
                             "steps, a ViT detection eval batch and an epoch "
                             "of the finetune driver; the tables go to DIR")
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
    kernel = ""
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
            mlp = re.search(r"mlp_gemmILi(\d)ELi(\d+)E", kernel)
            res = re.search(
                r"(res_[a-z_]+?)ILi(\d+)E(Lb1E)?.*?(Dense|Window)Rows", kernel)
            kernel = (f"mlp_gemm<mode {mlp[1]}, N tile {mlp[2]}>" if mlp
                      else f"{res[1]}<{res[2]}{', save-P' * bool(res[3])}, "
                           f"{res[4]}Rows>" if res else kernel[:60])
        elif any(w in line for w in ("registers", "spill", "wgmma",
                                     "setmaxnreg")):
            print(f"  ptxas: {kernel}: {line.strip()}")
    lib = _build.library()
    print("  fused MLP GEMM shared memory per block: " + ", ".join(
        f"mode {mode} N tile {bn}: {lib.ssl4gie_mlp_smem(mode, bn)} B"
        for mode, bn in ((0, 256), (0, 192), (0, 128), (1, 256), (1, 192),
                         (1, 128), (2, 128))))

    phases = [("kernels (classification shapes)", kernel_phase),
              ("kernels (rotation, its path shapes)", rotate_kernel_phase),
              ("kernels (detection shapes)", det_kernel_phase),
              ("kernels (MAE shapes)", mae_kernel_phase),
              ("kernels (MoCo shapes)", moco_kernel_phase),
              ("kernels (A/B variants)", variant_kernel_phase),
              ("classification path", main_path),
              *((f"{tag} path", functools.partial(dense_path, tag))
                for tag in DENSE_PATHS),
              ("detection path", det_path),
              ("RN50 detection path", det_rn50_path),
              ("detection eval (evaluate_map)", det_eval_path),
              ("MAE path", mae_path),
              *((f"MoCo {arch} path", functools.partial(moco_path, arch))
                for arch in MOCO_ARCHS),
              ("kernel A/B harnesses", harness_path),
              ("finetune driver", driver_path),
              ("pretrain driver", pretrain_driver_path)]
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
        profile_dense("seg", card, args.profile)
        profile_dense("rn50_seg", card, args.profile)
        profile_dense("vit_depth", card, args.profile)
        profile_det(card, args.profile)
        profile_det_rn50(card, args.profile)
        profile_det_eval(card, args.profile)
        profile_mae(card, args.profile)
        profile_moco(card, args.profile)
        profile_driver(card, args.profile)
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
