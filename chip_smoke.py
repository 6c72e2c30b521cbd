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
10. SSL finetune recipes: an MAE ViT-B and a MoCo v3 ViT-B export
   written by the port's pretraining code (`build_pretraining`,
   `PretrainRun.export`) from seeded init at full width, then through
   `cli/train.py`'s config and `build_trainer`, B=64, two epochs over the
   finetune driver's 320 synthetic images each: MAE's finetune recipe
   (--checkpoint the MAE export, --layer-decay 0.65 --drop-path 0.1
   --mixup 0.8 --cutmix 1.0 --smoothing 0.1 --aa rand-m9-mstd0.5-inc1
   --reprob 0.25 --out-token global_pool), the MoCo v3 linear probe and
   the MAE linear probe. The load must give every backbone tensor the
   export holds, bitwise, and no other (global_pool's fc_norm and MAE's
   buffer pos_embed stay); the launches, read around every train step,
   12 attention forwards and 12 backwards in the MAE recipe and no
   rotation, 12 forwards and no backward in the probes (their frozen
   backbone takes no gradient); the probes' backbones bitwise unchanged
   and only the head (and head_bn's statistics) moved; every mixed batch's
   soft-target rows summing to 1 within 1e-6. A reference-format copy of
   the MoCo export ({'state_dict': {'module.base_encoder.' + name}}, the
   projector under `head.`) and `cli.convert`'s output of it must load to
   the same backbone bitwise. One timm batch (B=64, float32) on the card
   against the same draws on the CPU (the erasing noise copied across):
   at most 0.1% of the values one uint8 level apart (a bilinear value at
   .5 within the two devices' rounding, before the requantization), the
   rest within 1e-5; and the transfer transforms on a 32 px CIFAR-shaped
   batch within 1e-5. Prints each recipe's ms/step after epoch 1 and the
   timm stack's ms per batch.
11. Exact warp: one classification (ViT-B/16, B=64) and one
   segmentation (ViT-B + DPT, B=48) full step with `exact=True`, factors
   from a host generator: no rotation launch, 12 + 12 attention launches
   each, and every warp on the card (`affine_sample`'s one-pass nearest
   gather, bf16) equal element for element to the same op on the CPU at
   the same matrix.
12. Detection driver: 24 Kvasir-like frames written as JPEGs in the Kvasir
   layout (`images/`, `bounding-boxes.json`; `split_ids`: 20 train, 2
   val, 2 test) and `build_trainer` on a `cli/train.py --task detection`
   command line: the ViT-B detector (1024 px, fixed placement, B=4, the
   full proposal counts, bf16 over f32 masters) `fit()` for two epochs,
   the end state written as a requeue slot after epoch 2, a second build
   with --epochs 3 that resumes bitwise and runs epoch 3; exactly 8 window
   + 8 + 4 flash + 4 launches in every train step and 8 + 4 forwards in
   every eval batch, read around each call. Then `cli.evaluate.main` on the
   ViT-B slot, with the test frames' ground truth made of the slot's own
   best detections: its mAP dict equal to `evaluate_map` on the slot
   restored by hand, mAP@50 at least 0.9. The three renders of
   `tasks/predict.py` on the card held to float32 on the CPU (detection on
   two test frames from the slot, its class bias shifted so that boxes
   pass 0.5, box for box by score and IoU, 8 + 4 forwards an image;
   segmentation and depth from ViT-B + DPT slots of random weights, 12
   forwards an image) and `cli.predict.main` writing their PNGs, then the
   RN50-FPN
   through the same trainer for one epoch (1344 px, torchvision
   placement, no kernel). Prints the driver's ms/step beside the bare
   steps', ms per eval batch, the host copies, the save, the slot's bytes,
   the resume's load and peak memory.
13. Multi-GPU (one card): (a) `build_trainer`'s ViT-B/16 classification
   trainer (B=64) under DDP through NCCL at world size 1 (a FileStore
   group) against the same trainer without a group, from the same
   weights, batches and generators: 5 steps bitwise equal (losses and
   parameters), 12 + 12 + 1 launches a step, both ms/step; (c) the ViT-B
   detection step at 1024 px under DDP at world size 1, 8 + 8 + 4 + 4
   launches a step; (b) two ranks on the one card over gloo with CUDA
   tensors (`chip_smoke.py --mgpu-rank R`, spawned): the same trainer as
   DP (32 images a rank), tensor-parallel over both ranks (#1/#2 on 6 of
   the 12 heads a rank) and FSDP2, 3 steps each, 12 + 12 + 1 launches a
   step on each rank and the first loss within 2^-6 of (a)'s; and MAE's
   encoder MLP (B=256) through the fused route (#8/#9) under TP, 1536
   hidden units a rank, one launch each way, within 2^-6 of the whole MLP
   unfused. Per-rank launches and ms/step on their own lines.
14. Float32 compute and the head width 80 (the MAE ViT-H), each phase
   beside the bf16 one it mirrors: (a) the kernel phase holds the float32
   instances (FFMA, `csrc/attention_f32.cuh`) of #1/#2 at (64, 197) 12 x 64,
   (256, 197) 16 x 32 and (64, 180) 16 x 80, of #4/#5 on the detection grid
   and the eval batch's, of #6/#7 at (48, 4096, 64), the eval batch's and
   the masked cases, and the bf16 Dh-80 instance of #1/#2 at (64, 180),
   against their plain versions (float32: outputs within 1e-5 and gradients
   within 1e-4 of the largest value; the bound at the card's float32 peak,
   66.9 TFLOP/s, SDPA in float32); (b) `build_trainer` on the finetune
   driver's command line plus --compute-dtype float32, a few steps, twice:
   exactly 12 float32 #1, 12 float32 #2 and one bf16 #3 a step, the two
   runs' parameters bitwise equal, the logits within 1e-3 of the largest
   against float32 on the CPU; (c) the ViT-B detection trainer of a
   `cli/train.py --task detection --compute-dtype float32` command line
   (1024 px, B=4): 8 + 8 float32 window and 4 + 4 float32 flash launches a
   step, an eval forward, the backbone map within 1e-3 at 512 px; (d) the
   MAE ViT-H/14 from `build_pretraining` at B=64: at --mask-ratio 0.75 only
   the decoder's 8 + 8 Dh-32 launches, at 0.3 also 32 + 32 Dh-80 ones, the
   loss within 1% of float32 on the CPU at B=2; then --compute-dtype
   float32 at B=8, the encoder cut to 4 blocks, 4 + 4 float32 Dh-80 and
   8 + 8 float32 Dh-32 launches, the loss within 1e-3; (e) the float32
   policy's cost (`core/config.py:float32_policy`, set for every phase):
   the RN50 seg step under it and under PyTorch's defaults, bf16 and
   float32 compute.
15. Prints the card's name and power limit, one JSON line of per-kernel
   results (the detection kernels' rows also carry the detection driver's
   launches per train step and per eval batch, #1/#2's the recipes' per
   train step, and the multi-GPU phase's per step as `mgpu_<leg>_...`),
   then the last line
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
import copy
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
from ssl4gie_tpu_torch.cli import convert as cli_convert
from ssl4gie_tpu_torch.cli import pretrain as cli_pretrain
from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                           PretrainConfig, Task,
                                           float32_policy)
from ssl4gie_tpu_torch.core.schedule import cosine_momentum
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.convert.loaders import load_vit_encoder
from ssl4gie_tpu_torch.core.checkpoint import host_copy
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.data.augment import (IMAGENET_STD, eval_batch,
                                            normalize)
from ssl4gie_tpu_torch.data.loader import SyntheticSource, prefetch_to_device
from ssl4gie_tpu_torch.data.randaug import (erasing_noise, sample_timm_params,
                                            timm_train_batch)
from ssl4gie_tpu_torch.data.ssl_augment import (mae_augment, moco_two_crops,
                                                sample_mae_params,
                                                sample_moco_params)
from ssl4gie_tpu_torch.data.transfer import (sample_transfer_params,
                                            transfer_eval_batch,
                                            transfer_train_batch)
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
                                              ResNetDepthModel, ViTDenseModel,
                                              build_model)
from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.ssl.mae import MAE, MAE_SIZES
from ssl4gie_tpu_torch.ssl.moco_v3 import (STOP_GRAD_ARCHS, VIT_PRESETS,
                                           MoCoEncoder)
from ssl4gie_tpu_torch.ssl.pretrain import (PretrainRun, SyntheticUnlabeled,
                                            build_pretraining,
                                            make_mae_full_step,
                                            make_mae_optimizer, make_schedule)
from ssl4gie_tpu_torch.tasks.detection import (TV_CANVAS, DetectionSource,
                                               SyntheticDetectionSource,
                                               boxes_to_original,
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
# and its float32 peak outside the tensor cores (FFMA), the float32
# instances' bound: no tensor-core product keeps float32's precision
PEAK_F32_FLOPS = 66.9e12
# float32 compute (`--compute-dtype float32`): the float32 instances'
# outputs within 1e-5 of the largest value and gradients within 1e-4 of
# their plain versions; a float32 model on the card within 1e-3 of the
# largest value of a float32 CPU run of the same weights (the bf16 paths'
# 5% does not apply)
F32_OUT_TOL, F32_GRAD_TOL, F32_MODEL_TOL = 1e-5, 1e-4, 1e-3


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


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least time the card could take for the work (ms), and which of
    its operations (at `peak`: PEAK_FLOPS for bf16 tensor-core work,
    PEAK_F32_FLOPS for float32) and its bytes (at PEAK_BYTES) bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def result(name, source, replaces, err, ms, plain_ms, library_ms, flops,
           nbytes, peak: float = PEAK_FLOPS, **extra) -> dict:
    """One kernel's entry of the JSON line (launches are added later); the
    bound at `peak`, stated beside it."""
    bound_ms, bound_by = bound(flops, nbytes, peak)
    return {"name": name, "route": "cuda",
            "source": f"ssl4gie_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_peak_tflops": peak / 1e12, "library_ms": library_ms,
            **extra}


def tflops(flops: float, ms: float) -> str:
    """The rate of `flops` operations in `ms` milliseconds, as printed."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def attn_work(seqs: int, heads: int, n: int, dh: int, backward: bool,
              itemsize: int = 2):
    """FLOPs and bytes of packed-QKV attention over `seqs` sequences:
    forward 2 products (Q.K^T, P.V), backward 5 (S, dP, dV, dQ, dK) of
    2 n^2 dh each per head; bytes: forward qkv in, out and lse out;
    backward qkv, out, lse, dO in and dqkv out (`itemsize` bytes an
    element: bf16 2, float32 4; lse f32)."""
    tok, c = seqs * n, heads * dh
    flops = (10 if backward else 4) * seqs * heads * n * n * dh
    lse = seqs * heads * n * 4
    if backward:
        return flops, tok * (3 * c + c + c + 3 * c) * itemsize + lse
    return flops, tok * (3 * c + c) * itemsize + lse


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

class InstanceCount:
    """One instance's launches of a kernel wrapper, read and set as
    `launches` like a wrapper's own count: the float32 instance's
    (`launches_f32`), or, given a head width, the dense kernel's launches
    at one (dtype, Dh) (`launches_by_dh`)."""

    def __init__(self, fn, dtype=torch.float32, dh: int | None = None):
        self.fn, self.dtype, self.dh = fn, dtype, dh

    @property
    def launches(self) -> int:
        if self.dh is None:
            return self.fn.launches_f32
        return self.fn.launches_by_dh[self.dtype, self.dh]

    @launches.setter
    def launches(self, n: int) -> None:
        if self.dh is None:
            self.fn.launches_f32 = n
        else:
            self.fn.launches_by_dh[self.dtype, self.dh] = n


# every kernel's launch counter: a path's launches are checked on all of
# them (those it does not run must stay at 0). The bf16 instances count in
# `launches`; the float32 ones apart (`_f32`), and the dense kernel's
# Dh-80 launches also apart (`_dh80`, bf16; `_f32_dh80`)
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
            "window_v2_bwd": av.window_v2_bwd,
            **{f"{name}_f32": InstanceCount(fn) for name, fn in (
                ("dense_attention_fwd", da.attention_fwd),
                ("dense_attention_bwd", da.attention_bwd),
                ("window_attention_fwd", wa.window_attention_fwd),
                ("window_attention_bwd", wa.window_attention_bwd),
                ("flash_attention_fwd", fa.flash_fwd),
                ("flash_attention_bwd", fa.flash_bwd))},
            **{f"dense_attention_{d}{sfx}_dh80": InstanceCount(fn, dt, 80)
               for d, fn in (("fwd", da.attention_fwd),
                             ("bwd", da.attention_bwd))
               for sfx, dt in (("", torch.bfloat16),
                               ("_f32", torch.float32))}}


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


def dense_setup(tag: str, dtype=torch.bfloat16):
    """A path of DENSE_PATHS: its model (bf16 compute, or `dtype`, over f32
    masters, random weights from SEED) on the card, its optimizer, the full
    step, the batch and a generator on the card (augmentation factors,
    dropout)."""
    _, build, task, kind, _ = DENSE_PATHS[tag]
    dev = torch.device("cuda")
    model = build(dtype, dev, torch.Generator().manual_seed(SEED))
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
                "flash_attention_bwd": fa.flash_bwd,
                **{f"{name}_f32": COUNTERS[f"{name}_f32"] for name in (
                    "window_attention_fwd", "window_attention_bwd",
                    "flash_attention_fwd", "flash_attention_bwd")}}


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
                "flash_attention_bwd": n_global * n_steps,
                **{name: 0 for name in DET_COUNTERS if name.endswith("_f32")}}
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
    DET_MS_STEP["vit_b"] = ms_step
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
    return {k: v for k, v in launches.items() if not k.endswith("_f32")}


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
    DET_MS_STEP["resnet50"] = dt / DET_TIMED_STEPS * 1e3
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


def driver_config(ckpt_dir: str, epochs: int, argv=()):
    """The port's TrainConfig of DRIVER_ARGV (plus `argv`), as
    `cli/train.py` makes it."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        DRIVER_ARGV + ["--learning-rate-scheduler", "--epochs", str(epochs),
                       "--ckpt-dir", ckpt_dir, *argv]))
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


# the SSL finetune recipes through `cli/train.py`'s config and
# `build_trainer`, at full ViT-B width, B = 64, over the finetune driver's
# 320 synthetic images (5 train steps, 5 val and 5 test batches an epoch),
# two epochs, each from an export of the port's pretraining code
RECIPE_EPOCHS = 2
RECIPES = {
    # MAE's FINETUNE.md recipe for ViT-B
    "mae_finetune": ("mae", [
        "--pretraining", "Hyperkvasir", "--ss-framework", "mae",
        "--layer-decay", "0.65", "--drop-path", "0.1", "--mixup", "0.8",
        "--cutmix", "1.0", "--smoothing", "0.1", "--aa",
        "rand-m9-mstd0.5-inc1", "--reprob", "0.25", "--out-token",
        "global_pool"]),
    "moco_probe": ("mocov3", ["--probe", "--pretraining", "Hyperkvasir",
                              "--ss-framework", "mocov3"]),
    "mae_probe": ("mae", ["--probe", "--pretraining", "Hyperkvasir",
                          "--ss-framework", "mae"]),
}
# backbone tensors an export does not give: MAE's fixed sin-cos position
# embedding is a buffer of the MAE model (the classifier's sin-cos init is
# the same values), and the global_pool recipe's fc_norm starts fresh
# while the export's `norm` goes unused (`Models/mae/models_vit.py:28-31`)
RECIPE_UNLOADED = {"mae_finetune": {"pos_embed", "fc_norm.weight",
                                    "fc_norm.bias"},
                   "moco_probe": set(), "mae_probe": {"pos_embed"}}
# one timm batch on the card against the CPU: the share of values allowed
# one uint8 level apart (PIL's requantization floor(v + 0.5) of a bilinear
# value at .5 within the rounding of the two devices' arithmetic), the rest
# within TIMM_TOL; every soft-target row sums to 1 within SOFT_SUM_TOL
TIMM_LEVEL_SHARE, TIMM_TOL, SOFT_SUM_TOL = 1e-3, 1e-5, 1e-6
TRANSFER_TOL = 1e-5       # the transfer transforms, card against CPU
TRANSFER_B, TRANSFER_HW = 64, 32


def recipe_config(flags, ckpt_dir: str, checkpoint: str):
    """The port's TrainConfig of a recipe, as `cli/train.py` makes it."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        DRIVER_ARGV + flags + ["--epochs", str(RECIPE_EPOCHS),
                               "--ckpt-dir", ckpt_dir,
                               "--checkpoint", checkpoint]))
    cfg.data.synthetic_size = DRIVER_SYNTHETIC
    cfg.runtime.log_every = DRIVER_SYNTHETIC // B   # once an epoch
    return cfg


def write_exports(tmp: str) -> dict:
    """An MAE ViT-B and a MoCo v3 ViT-B export, each written by the port's
    pretraining code (`build_pretraining`, `PretrainRun.export`) from its
    seeded init at full width. Returns {framework: path}."""
    paths = {}
    for fw in ("mae", "mocov3"):
        run = build_pretraining(pretrain_config(fw, "vit_b", tmp, MOCO_B))
        run.export(0)
        paths[fw] = run.ckpt.path
        del run
    torch.cuda.empty_cache()
    return paths


def moco_reference_copy(export: str, path: str) -> None:
    """The MoCo export in the reference's format: {'state_dict':
    {'module.base_encoder.' + timm name: tensor}}, the projector under
    `head.` as the reference's base encoder holds it."""
    params = torch.load(export, weights_only=True)["params"]
    sd = {}
    for k, v in params.items():
        name = (k.removeprefix("backbone.") if k.startswith("backbone.")
                else "head." + k.removeprefix("projector."))
        sd["module.base_encoder." + name] = v
    torch.save({"state_dict": sd, "epoch": 0, "arch": "vit_base"}, path)


def zeroed_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` with every parameter and buffer zero."""
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for t in clone.state_dict().values():
            t.zero_()
    return clone


def check_same_backbone(what: str, a: torch.nn.Module,
                        b: torch.nn.Module) -> None:
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values(),
                         strict=True):
        if not torch.equal(v, w):
            raise AssertionError(f"{what}: {k} differs")


def recipe_run(name: str, export: str, tmp: str, card: str) -> dict:
    """One recipe: build (the load checked complete and bitwise), two
    epochs of `fit` with the launches read around every train step; the
    probes' backbones bitwise unchanged and only their head (and head_bn's
    statistics) moved; the soft-target rows. Returns the model, the count
    loaded, the per-step launches, the train steps and eval batches run and
    the epoch-2 step time."""
    fw, flags = RECIPES[name]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = build_trainer(recipe_config(flags, tmp, export))
    print(out.getvalue(), end="", flush=True)
    n = int(re.search(r"Loaded (\d+) converted tensors", out.getvalue())[1])
    model = trainer.model
    params = torch.load(export, weights_only=True)["params"]
    if fw == "mocov3":
        params = {k.removeprefix("backbone."): v for k, v in params.items()
                  if k.startswith("backbone.")}
    bb = model.backbone.state_dict()
    if set(bb) - set(params) != RECIPE_UNLOADED[name] or \
            n != len(set(bb) & set(params)):
        raise AssertionError(f"[{name}] loaded {n} of the export's "
                             f"{len(params)} tensors; not loaded "
                             f"{sorted(set(bb) - set(params))}")
    for k in set(bb) & set(params):
        if not torch.equal(bb[k], params[k].to(bb[k].device)):
            raise AssertionError(f"[{name}] {k} is not the export's")
    before = host_copy(model.state_dict())

    per_step, soft_err = [], []
    full_step = trainer.full_step

    def counted(*args, **kwargs):
        was = {k: fn.launches for k, fn in COUNTERS.items()}
        result = full_step(*args, **kwargs)
        per_step.append({k: fn.launches - was[k]
                         for k, fn in COUNTERS.items()
                         if fn.launches != was[k]})
        return result

    trainer.full_step = counted
    mixup_fn = trainer.task.mixup_fn
    if mixup_fn is not None:
        def checked(img, labels, gen):
            img, tgt = mixup_fn(img, labels, gen)
            soft_err.append((tgt.sum(1) - 1).abs().max())
            return img, tgt
        trainer.task.mixup_fn = checked
    trainer.fit()
    depth = len(model.backbone.blocks)
    want = {"dense_attention_fwd": depth}
    if name == "mae_finetune":
        want["dense_attention_bwd"] = depth      # no rotation: timm stack
    if any(s != want for s in per_step):
        raise AssertionError(f"[{name}] launches per train step "
                             f"{per_step} != {want}")
    if soft_err:
        err = float(torch.stack(soft_err).max())
        if err > SOFT_SUM_TOL:
            raise AssertionError(f"[{name}] soft-target rows sum to 1 +- "
                                 f"{err}")
        print(f"[recipes] {name}: every batch's soft-target rows sum to 1 "
              f"within {err:.2e} (tol {SOFT_SUM_TOL})", flush=True)
    after = model.state_dict()
    if name != "mae_finetune":
        moved = sorted(k for k, v in after.items()
                       if not torch.equal(v.cpu(), before[k]))
        want_moved = ["lin_head.bias", "lin_head.weight"]
        if fw == "mae":
            want_moved = ["head_bn.running_mean", "head_bn.running_var",
                          *want_moved]
        if moved != want_moved:
            raise AssertionError(f"[{name}] moved {moved} != {want_moved}")
    ledger = [json.loads(ln) for ln in
              Path(trainer.logger.jsonl_path).read_text().splitlines()]
    train = [p for p in ledger if "step" in p]
    if len(train) != RECIPE_EPOCHS or not all(
            np.isfinite([p["loss"] for p in train])):
        raise AssertionError(f"[{name}] losses {train}")
    steps = len(per_step)
    evals = RECIPE_EPOCHS * (len(trainer.val_loader)
                             + len(trainer.test_loader))
    print(f"[recipes] {name}: loaded {n} tensors of the export bitwise "
          f"(not loaded: {sorted(RECIPE_UNLOADED[name]) or 'none'}); "
          f"{steps} train steps, launches per step {per_step[0]}; "
          f"epoch 2 step_time_ms {train[-1]['step_time_ms']:.2f}, "
          f"images_per_sec {train[-1]['images_per_sec']:.1f} (the Loader "
          f"and the copies included), losses "
          f"{[round(p['loss'], 4) for p in train]}  [{card}]", flush=True)
    return {"model": model, "n": n, "steps": steps, "evals": evals,
            "depth": depth, "per_step": per_step[0],
            "ms": train[-1]["step_time_ms"]}


def timm_card_vs_cpu(card: str) -> None:
    """One timm batch (B = 64, 224 px, the recipe's policy and erasing) on
    the card against the same batch on the CPU, the same draws and the
    card's erasing noise copied across; its device ms per batch."""
    src = SyntheticSource(B, IMG, seed=SEED)
    img = torch.from_numpy(np.stack([src.get(i)["image"]
                                     for i in range(B)]))
    params = sample_timm_params(B, IMG, torch.Generator().manual_seed(SEED),
                                "rand-m9-mstd0.5-inc1", 0.25)
    noise = erasing_noise((B, IMG, IMG, 3), params["noise_seed"], "cuda")
    gpu = timm_train_batch(img.cuda(), params, IMG, noise=noise)
    cpu = timm_train_batch(img, params, IMG, noise=noise.cpu())
    if gpu.dtype != torch.float32:
        raise AssertionError(f"timm batch dtype {gpu.dtype}")
    diff = (gpu.cpu() - cpu).abs()
    level = 1.0 / 255.0 / min(IMAGENET_STD)
    share = float((diff > TIMM_TOL).float().mean())
    if share > TIMM_LEVEL_SHARE or float(diff.max()) > level * 1.001:
        raise AssertionError(f"timm batch: {share:.2e} of the values off, "
                             f"max {float(diff.max()):.4g}")
    img_gpu = img.cuda()
    ms = cuda_ms(lambda: timm_train_batch(img_gpu, params, IMG), runs=10)
    print(f"[recipes] timm stack (RRC + flip + RandAugment m9 mstd0.5 inc1 "
          f"x2 + erasing 0.25, float32) at ({B}, {IMG}, {IMG}, 3): card "
          f"against CPU, {share:.2e} of the values off by at most one "
          f"level (max {float(diff.max()):.4g}; allowed share "
          f"{TIMM_LEVEL_SHARE}); {ms:.3f} ms per batch on the card (draws "
          f"on the host, copies included)  [{card}]", flush=True)


def transfer_card_vs_cpu(card: str) -> None:
    """One `transfer_train_batch` at injected draws and one
    `transfer_eval_batch` on a 32 px CIFAR-shaped batch, on the card
    against the CPU."""
    img = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (TRANSFER_B, TRANSFER_HW, TRANSFER_HW, 3), dtype=np.uint8))
    params = sample_transfer_params(TRANSFER_B, TRANSFER_HW,
                                    torch.Generator().manual_seed(SEED))
    errs = {}
    for what, fn in (("train", lambda x: transfer_train_batch(x, params,
                                                               IMG)),
                     ("eval", lambda x: transfer_eval_batch(x, IMG))):
        gpu, cpu = fn(img.cuda()), fn(img)
        errs[what] = float((gpu.cpu() - cpu).abs().max())
        if gpu.shape != (TRANSFER_B, IMG, IMG, 3) or \
                errs[what] > TRANSFER_TOL:
            raise AssertionError(f"transfer {what}: {tuple(gpu.shape)}, "
                                 f"max |card - CPU| {errs[what]}")
    print(f"[recipes] transfer transforms on ({TRANSFER_B}, {TRANSFER_HW}, "
          f"{TRANSFER_HW}, 3) -> {IMG} px, card against CPU: max |diff| "
          f"train {errs['train']:.2e}, eval {errs['eval']:.2e} (tol "
          f"{TRANSFER_TOL})  [{card}]", flush=True)


def recipes_path(card: str) -> dict:
    """The SSL finetune recipes at full width: the two exports, then the
    MAE finetune recipe and the two probes through `build_trainer` and
    `fit` (`recipe_run`); a reference-format copy of the MoCo export and
    `cli.convert`'s output of it loaded to the same backbone, bitwise; the
    timm stack and the transfer transforms on the card against the CPU.
    Checks every kernel counter over the phase. Returns the launch counts
    keyed `<kernel>_recipes` and the per-step ones keyed
    `<kernel>_recipe_<name>_step`."""
    for fn in COUNTERS.values():
        fn.launches = 0
    runs = {}
    with tempfile.TemporaryDirectory(prefix="ssl4gie_recipes_") as tmp:
        exports = write_exports(tmp)
        for name in RECIPES:
            runs[name] = recipe_run(name, exports[RECIPES[name][0]],
                                    os.path.join(tmp, name), card)
            if name == "moco_probe":
                ref = os.path.join(tmp, "moco_reference.pth.tar")
                moco_reference_copy(exports["mocov3"], ref)
                conv = os.path.join(tmp, "moco_converted.pt")
                with contextlib.redirect_stdout(io.StringIO()):
                    cli_convert.main(["--input", ref, "--output", conv])
                # the probe left the loaded backbone bitwise as it was
                backbone = runs[name]["model"].backbone
                for what, path in (("reference copy", ref),
                                   ("cli.convert output", conv)):
                    clone = zeroed_copy(backbone)
                    n = load_vit_encoder(path, clone)
                    if n != runs[name]["n"]:
                        raise AssertionError(f"MoCo {what}: {n} tensors "
                                             f"loaded, not {runs[name]['n']}")
                    check_same_backbone(f"MoCo {what}", clone, backbone)
                    print(f"[recipes] MoCo export as a {what}: {n} tensors, "
                          "the same backbone bitwise", flush=True)
                    del clone
            runs[name].pop("model")
            torch.cuda.empty_cache()
    total_fwd = sum(r["depth"] * (r["steps"] + r["evals"])
                    for r in runs.values())
    total_bwd = sum(r["depth"] * r["steps"] for r in runs.values()
                    if "dense_attention_bwd" in r["per_step"])
    ran = check_launches("recipes", {"dense_attention_fwd": total_fwd,
                                     "dense_attention_bwd": total_bwd})
    timm_card_vs_cpu(card)
    transfer_card_vs_cpu(card)
    out = {f"{k}_recipes": v for k, v in ran.items()}
    for name, r in runs.items():
        for k, v in r["per_step"].items():
            out[f"{k}_recipe_{name}_step"] = v
    return out


# the detection driver: Kvasir-like frames (w, h) written as JPEGs in the
# Kvasir layout, 24 of them (`split_ids`: 20 train, 2 val, 2 test, so 5
# steps an epoch at B = DET_B); the two widest exceed the 1024 px canvas
# (the ViT placement halves them)
DET_DRIVER_SIZES = ((622, 529), (576, 720), (1000, 800), (720, 576),
                    (1280, 1024), (652, 489), (768, 576), (1350, 1080))
DET_DRIVER_FRAMES, DET_DRIVER_STEPS = 24, 5
# the finetune driver's ledger keys for detection (JAX `DetectionTrainer`)
DET_DRIVER_LEDGER_KEYS = [
    {"epoch", "step", "loss", "images_per_sec", "step_time_ms", "wall_s"},
    {"epoch", "val_map", "val_map50", "wall_s"},
    {"epoch", "test_map", "test_map50", "wall_s"},
    {"epoch", "new_best_val_map", "test_map_at_best", "wall_s"},
    {"epoch", "lr_reduced_to", "wall_s"},
    {"resumed_from_epoch", "best_val", "wall_s"}]
# the dense predictors' slots: random ViT-B + DPT weights, 224 px
PREDICT_DENSE = {"segmentation": "seg", "depth": "depth"}
DET_MS_STEP = {}      # the bare detection step, ms (the driver's yardstick)
# the cli.evaluate check makes the test frames' ground truth of this many
# best detections over both
DET_ORACLE_GT = 6


def write_kvasir(root: str) -> None:
    """DET_DRIVER_FRAMES random frames with one to three painted boxes each
    (FrameSource's draws), as `images/frameNN.jpg` and
    `bounding-boxes.json`, the Kvasir-SEG detection layout."""
    from PIL import Image
    os.makedirs(os.path.join(root, "images"))
    src = FrameSource([DET_DRIVER_SIZES[i % len(DET_DRIVER_SIZES)]
                       for i in range(DET_DRIVER_FRAMES)], DET_IMG, "fixed")
    targets = {}
    for i in range(DET_DRIVER_FRAMES):
        img, boxes, _ = src.decode(i)
        Image.fromarray(img).save(os.path.join(root, "images",
                                               f"frame{i:02d}.jpg"),
                                  quality=90)
        targets[f"frame{i:02d}"] = {"bbox": [
            dict(zip(("xmin", "ymin", "xmax", "ymax"), map(float, b)))
            for b in boxes]}
    with open(os.path.join(root, "bounding-boxes.json"), "w") as f:
        json.dump(targets, f)


def det_driver_argv(root: str, ckpt_dir: str, arch: str) -> list:
    return ["--task", "detection", "--architecture", arch, "--dataset",
            "Kvasir", "--data-root", root, "--batch-size", str(DET_B),
            "--ckpt-dir", ckpt_dir]


def det_driver_config(root: str, ckpt_dir: str, arch: str, epochs: int,
                      argv=()):
    """The port's TrainConfig of a `cli/train.py` detection command line
    (plateau on, the loss logged once an epoch; plus `argv`)."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        det_driver_argv(root, ckpt_dir, arch)
        + ["--learning-rate-scheduler", "--epochs", str(epochs), *argv]))
    cfg.runtime.log_every = DET_DRIVER_STEPS
    return cfg


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every box of `a` (n, 4) with every box of `b` (m, 4), xyxy."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], axis=-1)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def _score_cut(scores: np.ndarray, k: int) -> float:
    """The score midway, in logits, between the k-th and the (k + 1)-th
    highest of `scores` (one logit below the last when there are no more
    than k)."""
    z = np.sort(_logit(scores))[::-1]
    if len(z) < k:
        raise AssertionError(f"{len(z)} detections, fewer than {k}")
    t = (z[k - 1] + z[k]) / 2 if len(z) > k else z[-1] - 1.0
    return float(1.0 / (1.0 + np.exp(-t)))


def _widest_cut(scores: np.ndarray, lo: int, hi: int) -> float:
    """`_score_cut` at the k in [lo, hi] whose k-th and (k + 1)-th highest
    scores lie furthest apart in logits."""
    z = np.sort(_logit(scores))[::-1]
    ks = range(lo, min(hi, len(z) - 1) + 1)
    if not ks:
        raise AssertionError(f"{len(z)} detections, fewer than {lo + 1}")
    return _score_cut(scores, max(ks, key=lambda k: z[k - 1] - z[k]))


def _held(boxes, z, other_boxes, other_z, tol: float) -> np.ndarray:
    """For each box of one side (logits `z`): its best IoU with a box of
    the other side whose logit lies within `tol` of its own; 0 where
    there is none."""
    if not len(boxes) or not len(other_boxes):
        return np.zeros(len(boxes))
    close = np.abs(z[:, None] - other_z[None, :]) <= tol
    return np.where(close, _iou(boxes, other_boxes), 0.0).max(axis=1)


def hold_detection_render(model, sample: dict, tag: str) -> np.ndarray:
    """The detection render on the card against the float32 detector on
    the CPU (the same weights). A detector trained for a few steps scores
    every box below the render's 0.5, so the box head's class bias is
    shifted alike on both, to put 0.5 in the widest logit gap between two
    of the CPU's 3rd to 11th best scores. The render's own detections
    (`detect`, with the sample's content size) then agree, in logits of
    the scores, within LOGIT_TOL of the largest logit of the CPU's
    unshifted detections (the tolerance of the segmentation render): every
    box that the CPU keeps (score > 0.5) beyond that band around 0.5 has a
    box kept on the card, and every box kept on the card has one kept on
    the CPU or inside the band, each with a logit within the tolerance
    and an IoU of at least 0.5, the box NMS threshold (when two near-equal
    scores swap their order, NMS keeps the other box of the pair, which
    overlaps by more than that). Nothing kept on either side fails, and so
    does a render without predicted boxes or of another shape than the
    original. Returns the card render."""
    from ssl4gie_tpu_torch.tasks import predict as P
    ref_model = FasterRCNN(arch=model.arch, image_size=model.image_size,
                           dtype=torch.float32, device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    _, ref_scores = P.detect(ref_model, sample)
    tol = LOGIT_TOL * float(np.abs(_logit(ref_scores)).max())
    shift = -float(_logit(_widest_cut(ref_scores, 3, 10)))
    bias = model.roi_heads.box_predictor.cls_score.bias
    saved = bias.detach().clone()
    with torch.no_grad():
        bias.add_(torch.tensor([-shift / 2, shift / 2], dtype=bias.dtype,
                               device=bias.device))
        ref_model.roi_heads.box_predictor.cls_score.bias.copy_(bias.cpu())
    try:
        for fn in COUNTERS.values():
            fn.launches = 0
        boxes, scores = P.detect(model, sample)
        check_launches(tag, {"window_attention_fwd": 8,
                             "flash_attention_fwd": 4})
        out = P.draw_detections(sample, boxes[scores > 0.5])
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    ref_boxes, ref_scores = P.detect(ref_model, sample)
    z, ref_z = _logit(scores), _logit(ref_scores)
    keep, ref_keep = z > 0, ref_z > 0
    sure, near = ref_z > tol, ref_z > -tol
    iou = np.concatenate([
        _held(ref_boxes[sure], ref_z[sure], boxes[keep], z[keep], tol),
        _held(boxes[keep], z[keep], ref_boxes[near], ref_z[near], tol)])
    # each kept box's score against its best-overlapping CPU box, in bf16
    # ulps of the CPU's score and in logits
    gap_ulps = gap_z = 0.0
    if keep.any() and ref_keep.any():
        j = _iou(boxes[keep], ref_boxes).argmax(axis=1)
        gap_ulps = float(np.max(np.abs(scores[keep] - ref_scores[j])
                                / _bf16_ulp(ref_scores[j])))
        gap_z = float(np.max(np.abs(z[keep] - ref_z[j])))
    drawn = int((out == P.PRED_COLOR).all(-1).sum())
    print(f"[{tag}] render {out.shape}: class logits shifted by "
          f"{shift:.4f}; kept {int(keep.sum())} on the card, "
          f"{int(ref_keep.sum())} in f32 on the CPU ({int(sure.sum())} "
          f"beyond the band), of {len(z)} and {len(ref_z)} detections; held "
          f"at IoU >= 0.5 with logits within {tol:.4f}: "
          f"{int((iou >= 0.5).sum())} of {len(iou)} ({int((iou >= 0.9).sum())}"
          f" at IoU >= 0.9, the least "
          f"{iou.min() if len(iou) else float('nan'):.4f}); largest gap to "
          f"the best-overlapping CPU box {gap_z:.4f} in logits, "
          f"{gap_ulps:.2f} bf16 ulps of the score; {drawn} predicted-box "
          f"pixels drawn", flush=True)
    if not keep.any() or not sure.any() or (iou < 0.5).any() or \
            not drawn or out.shape != sample["original"].shape:
        raise AssertionError(f"{tag}: the card's detections disagree with "
                             "the f32 CPU run's")
    return out


def _cmap_index(rgb: np.ndarray, name: str) -> np.ndarray:
    """The entry of colormap `name` nearest each pixel of `rgb`."""
    from ssl4gie_tpu_torch.tasks.colormaps import COLORMAPS
    table = COLORMAPS[name].astype(np.int32)
    d = np.abs(rgb.astype(np.int32)[..., None, :] - table).sum(-1)
    return d.argmin(-1)


def hold_dense_render(task: str, model, sample: dict, tag: str) -> float:
    """`render_segmentation` / `render_depth` on the card against the same
    render of the float32 model on the CPU: the masks agree wherever the
    CPU logit is beyond LOGIT_TOL of the largest from 0; the colormaps'
    entries agree within LOGIT_TOL of the 256 entries (plus one: the
    floor). Returns the share of excepted pixels."""
    from ssl4gie_tpu_torch.tasks import predict as P
    from ssl4gie_tpu_torch.tasks.evaluate import _forward_fn
    ref_model = ViTDenseModel(dense=PREDICT_DENSE[task],
                              dtype=torch.float32, device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    if task == "segmentation":
        out, ref = (P.render_segmentation(m, sample)
                    for m in (model, ref_model))
        logits = _forward_fn(ref_model)[0](sample["image"][None])
        logits = logits[0, :, :, 0].numpy()
        tie = np.abs(logits) <= LOGIT_TOL * np.abs(logits).max()
        bad = (out != ref) & ~tie
        share = float(tie.mean())
    else:
        outs, refs = (P.render_depth(m, sample) for m in (model, ref_model))
        reach = int(math.ceil(LOGIT_TOL * 256)) + 1
        bad = np.zeros(outs[0].shape[:2], bool)
        for o, r, name in zip(outs, refs, ("magma", "bone")):
            bad |= np.abs(_cmap_index(o, name) - _cmap_index(r, name)) > reach
        share = 0.0
    print(f"[{tag}] {task} render bf16 on card vs f32 on CPU: "
          f"{int(bad.sum())} pixels disagree ({share:.4f} of the mask within "
          f"the tolerance of 0, excepted)", flush=True)
    if bad.any():
        raise AssertionError(f"{tag}: the {task} render disagrees")
    return share


def exact_affine_path(card: str) -> dict:
    """One classification and one segmentation full step with `exact=True`
    at full width (ViT-B/16; ViT-B + DPT), factors from a host generator:
    no rotation launch (the warp is `affine_sample`'s one-pass gather), the
    attention launches of the models; each warp on the card equals
    `affine_sample` on the CPU at the same matrix, element for element."""
    from ssl4gie_tpu_torch.data import augment as taug
    calls = []
    gather = taug.affine_sample

    def recording(img, matrix, fill, mode="nearest"):
        out = gather(img, matrix, fill, mode)
        calls.append((img.detach().clone(), matrix.detach().clone(), fill,
                      mode, out.detach().clone()))
        return out

    def cls_case():
        model, optimizer, _, img_u8, labels, _ = cls_setup()
        return model, optimizer, CLS_TASK, img_u8, labels

    def seg_case():
        model, optimizer, _, img_u8, masks, _ = dense_setup("seg")
        return model, optimizer, segmentation_task(), img_u8, masks

    attention = {"dense_attention_fwd": 12, "dense_attention_bwd": 12}
    out = {}
    taug.affine_sample = recording
    try:
        for tag, setup, expected in (("cls", cls_case, attention),
                                     ("seg", seg_case, attention)):
            model, optimizer, task, img_u8, targets = setup()
            step = make_full_step(task, exact=True, per_image_jitter=False)
            for fn in COUNTERS.values():
                fn.launches = 0
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(model, optimizer, img_u8, targets,
                        torch.Generator().manual_seed(SEED),
                        torch.Generator(device="cuda").manual_seed(SEED))
            loss = float(loss["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            ran = check_launches(f"exact {tag}", expected)
            if not np.isfinite(loss):
                raise AssertionError(f"exact {tag}: loss {loss}")
            for img, m, fill, mode, got in calls:
                ref = gather(img.cpu(), m.cpu(), fill, mode)
                if not torch.equal(got.cpu(), ref):
                    raise AssertionError(f"exact {tag}: the card's warp "
                                         "differs from the CPU's")
            print(f"[exact {tag}] exact affine full step B={img_u8.shape[0]}"
                  f": {len(calls)} warps ({tuple(calls[0][0].shape)}, "
                  f"{calls[0][0].dtype}) equal to the CPU's element for "
                  f"element, no rotation launch, loss {loss:.4f}, "
                  f"{ms:.2f} ms (first step, build included)  [{card}]",
                  flush=True)
            out.update({f"{k}_exact_{tag}": v for k, v in ran.items()})
            del model, optimizer
    finally:
        taug.affine_sample = gather
    return out


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def _launched_since(before: dict) -> dict:
    """The launches of each kernel since `before` (those that moved)."""
    return {name: fn.launches - before[name] for name, fn in COUNTERS.items()
            if fn.launches != before[name]}


def watch_det_driver(trainer, steps: list, evals: list) -> None:
    """Wrap the trainer's full step and its evaluate: each step appends
    its launches to `steps`; each evaluate appends (its ms on the host
    clock with the device synchronized, its batches, its launches) to
    `evals`."""
    step, evaluate = trainer.full_step, trainer.evaluate

    def full_step(*args, **kwargs):
        before = _launch_counts()
        out = step(*args, **kwargs)
        steps.append(_launched_since(before))
        return out

    def watched_evaluate(source, epoch, split):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(source, epoch, split)
        torch.cuda.synchronize()
        evals.append(((time.perf_counter() - t0) * 1e3,
                      -(-len(source) // min(2, len(source))),
                      _launched_since(before)))
        return out

    trainer.full_step, trainer.evaluate = full_step, watched_evaluate


def det_driver_path(card: str) -> dict:
    """The detection driver at full width through its entry points, on
    JPEG files in the Kvasir layout: `build_trainer` on a `cli/train.py`
    command line for the ViT-B detector (1024 px, fixed placement, B =
    DET_B), `fit()` for two epochs; the end state written as the requeue
    slot of a three-epoch run preempted after its second epoch; a second
    `build_trainer` with --epochs 3 that resumes at epoch 3 (weights and
    AdamW state bitwise the saved ones) and runs it. The launches of every
    train step and every eval batch are read around each call. Then
    `cli.evaluate.main` on the ViT-B slot against `evaluate_map` on the
    slot restored by hand; the three renders of `tasks/predict.py` on the
    card held to float32 on the CPU (detection on two test frames from the
    ViT-B slot; segmentation and depth from ViT-B + DPT slots of random
    weights), with their launch counts, and `cli.predict.main` writing
    PNGs for each; the RN50-FPN through the same trainer (1344 px,
    torchvision placement) for one epoch. Returns the launch counts per
    train step and per eval batch, as measured, keyed
    `<kernel>_det_driver_step` / `_det_driver_eval`."""
    from ssl4gie_tpu_torch.cli import predict as cli_predict
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    from ssl4gie_tpu_torch.tasks import predict as P
    per_step = {"window_attention_fwd": 8, "window_attention_bwd": 8,
                "flash_attention_fwd": 4, "flash_attention_bwd": 4}
    per_eval = {"window_attention_fwd": 8, "flash_attention_fwd": 4}
    with tempfile.TemporaryDirectory(prefix="ssl4gie_det_driver_") as tmp:
        root, ckpt_dir = os.path.join(tmp, "Kvasir"), os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        write_kvasir(root)
        print(f"[det_driver] {DET_DRIVER_FRAMES} JPEG frames written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(det_driver_config(root, ckpt_dir, "vit_b", 2))
        n_train = len(trainer.train_loader)
        if (n_train, len(trainer.train_loader.source)) != (DET_DRIVER_STEPS,
                                                          20):
            raise AssertionError(f"split {n_train} steps of "
                                 f"{len(trainer.train_loader.source)}")
        step_runs, eval_runs = [], []
        snap_ms, save_ms, load_ms = [], [], []
        watch_det_driver(trainer, step_runs, eval_runs)
        timed(trainer, "_ckpt_tree", snap_ms)
        timed(trainer.ckpt, "save", save_ms)
        trainer.fit()
        trainer.preempt_ckpt.save(trainer._ckpt_tree(2, trainer.best_val,
                                                     0.0))
        size = os.path.getsize(trainer.preempt_ckpt.path)

        resumed = build_trainer(det_driver_config(root, ckpt_dir, "vit_b",
                                                  3))
        timed(resumed, "maybe_resume", load_ms)
        resume = resumed.maybe_resume

        def resume_and_check():
            resume()
            _equal_states(resumed.model.state_dict(),
                          trainer.model.state_dict(), "model")
            _equal_states(resumed.optimizer.state_dict(),
                          trainer.optimizer.state_dict(), "optimizer")

        resumed.maybe_resume = resume_and_check
        watch_det_driver(resumed, step_runs, eval_runs)
        resumed.fit()
        if resumed.start_epoch != 3 or resumed.preempt_ckpt.exists():
            raise AssertionError(f"resumed at epoch {resumed.start_epoch}, "
                                 "expected 3 (and the requeue slot deleted)")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # every step and every eval batch launched what it should, and
        # nothing launched outside them
        steps = len(step_runs)
        evals = sum(n for _, n, _ in eval_runs)
        if steps != 3 * n_train or any(r != per_step for r in step_runs):
            raise AssertionError(f"train step launches {step_runs}")
        for _, n, ran in eval_runs:
            if ran != {k: n * v for k, v in per_eval.items()}:
                raise AssertionError(f"eval launches {ran} over {n} batches")
        ran = check_launches("det_driver", {
            k: steps * per_step[k] + evals * per_eval.get(k, 0)
            for k in per_step})
        measured = {}
        for name in per_step:
            measured[f"{name}_det_driver_step"] = sum(
                r.get(name, 0) for r in step_runs) // steps
            measured[f"{name}_det_driver_eval"] = sum(
                r.get(name, 0) for _, _, r in eval_runs) // evals
        ledger = [json.loads(ln) for ln in
                  Path(trainer.logger.jsonl_path).read_text().splitlines()]
        for p in ledger:
            if set(p) not in DET_DRIVER_LEDGER_KEYS:
                raise AssertionError(f"ledger payload {sorted(p)} is not one "
                                     "of the JAX DetectionTrainer's")
        train_lines = [p for p in ledger if "step" in p]
        if len(train_lines) != 3 or not all(
                np.isfinite([p["loss"] for p in train_lines])):
            raise AssertionError(f"driver losses {train_lines}")
        for p in train_lines:
            print(f"[det_driver] epoch {p['epoch']}: step_time_ms "
                  f"{p['step_time_ms']:.2f}, images_per_sec "
                  f"{p['images_per_sec']:.2f} over {p['step']} steps (JPEG "
                  f"decode, placement and copies included), loss "
                  f"{p['loss']:.4f}; the bare step (det path) "
                  f"{DET_MS_STEP['vit_b']:.2f} ms/step  [{card}]", flush=True)
        batch_ms = [ms / n for ms, n, _ in eval_runs]
        kinds = {kind: {k.split("_det_driver_")[0]: v
                        for k, v in measured.items()
                        if k.endswith(kind) and v}
                 for kind in ("_step", "_eval")}
        print(f"[det_driver] launches measured around each of {steps} train "
              f"steps and {len(eval_runs)} evaluate calls ({evals} eval "
              f"batches): per step {kinds['_step']}, per eval batch "
              f"{kinds['_eval']}; "
              f"eval {statistics.median(batch_ms):.2f} ms per batch of 2 "
              f"(median over {len(batch_ms)} evaluate calls; "
              f"{[round(x, 2) for x in batch_ms]}); host copies "
              f"(`_ckpt_tree`) {[round(x, 1) for x in snap_ms]} ms; best-val "
              f"saves {[round(x, 1) for x in save_ms]} ms; slot {size} "
              f"bytes; resume load {[round(x, 1) for x in load_ms]} ms; "
              f"peak memory {peak:.2f} GiB  [{card}]", flush=True)

        # cli.evaluate on the ViT-B best-val slot against evaluate_map on
        # the slot restored by hand (build_model and the state dict) over
        # the trainer's own test source. The test frames' ground truth is
        # first replaced by the restored model's DET_ORACLE_GT best
        # detections over both frames, so that the two routes agree, and
        # mAP@50 is near 1, only if both load the slot, place the frames
        # and map the boxes to and from the originals alike.
        direct = build_model(Task.DETECTION, Architecture.VIT_B,
                             img_size=DET_IMG, dtype=torch.bfloat16,
                             device="cuda")
        direct.load_state_dict(torch.load(
            trainer.ckpt.path, map_location="cuda",
            weights_only=True)["model"])
        test = trainer.test_source
        test.keep_original = True
        samples = [test.get(i) for i in range(len(test))]
        dets = [P.detect(direct, s) for s in samples]
        cut = _score_cut(np.concatenate([sc for _, sc in dets]),
                         DET_ORACLE_GT)
        targets = json.loads(Path(root, "bounding-boxes.json").read_text())
        for path, s, (boxes, scores) in zip(test.paths, samples, dets):
            gt = boxes_to_original(boxes[scores > cut], s["pad"], s["scale"])
            targets[Path(path).stem] = {"bbox": [
                dict(zip(("xmin", "ymin", "xmax", "ymax"), map(float, b)))
                for b in gt]}
        Path(root, "bounding-boxes.json").write_text(json.dumps(targets))
        argv = det_driver_argv(root, ckpt_dir, "vit_b")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = cli_evaluate.main(argv + ["--results-root", tmp])
        print(text.getvalue(), end="", flush=True)
        want = evaluate_map(direct, DetectionSource(test.paths, targets,
                                                    DET_IMG))
        print(f"[det_driver] cli.evaluate {res}; evaluate_map on the slot "
              f"restored by hand {want}; ground truth: the {DET_ORACLE_GT} "
              f"best of {sum(len(sc) for _, sc in dets)} detections over "
              f"the two test frames (score > {cut:.4f})", flush=True)
        if res != want or not np.isfinite(list(res.values())).all() or \
                res["map_50"] < 0.9 or "mAP@75:" not in text.getvalue():
            raise AssertionError(f"cli.evaluate {res} != evaluate_map "
                                 f"{want}, or mAP@50 below 0.9")
        del direct

        # the detection render from the slot (the predict CLI's route),
        # two test frames (8 window and 4 flash forwards each)
        cfg = det_driver_config(root, ckpt_dir, "vit_b", 1)
        model, _ = cli_evaluate.load_eval_state(cfg)
        src = cli_evaluate.make_test_source(cfg)
        src.keep_original = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(2):
            hold_detection_render(model, src.get(i), "det_driver predict")
        print(f"[det_driver] predict_detection: two renders with their f32 "
              f"CPU references in {time.perf_counter() - t0:.2f} s", flush=True)
        out_dir = os.path.join(tmp, "pred_det")
        with contextlib.redirect_stdout(io.StringIO()):
            written = cli_predict.main(argv + ["--idx", "0,1", "--out-dir",
                                               out_dir])
        if [os.path.basename(p) for p in written] != ["det_0.png",
                                                      "det_1.png"]:
            raise AssertionError(f"cli.predict wrote {written}")
        del model, trainer, resumed

        # the segmentation and depth renders from random-weight slots
        for task in PREDICT_DENSE:
            pargv = ["--task", task, "--architecture", "vit_b",
                     "--synthetic", "--ckpt-dir", ckpt_dir]
            p = argparse.ArgumentParser()
            targs.add_common(p)
            targs.add_train(p)
            pcfg = targs.to_train_config(p.parse_args(pargv))
            dense = ViTDenseModel(dense=PREDICT_DENSE[task],
                                  dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(SEED),
                                  device="cuda")
            ckpt_lib.CheckpointManager(ckpt_dir, pcfg.run_name()).save(
                {"model": ckpt_lib.host_copy(dense.state_dict()),
                 "meta": {"epoch": 0}})
            del dense
            model, _ = cli_evaluate.load_eval_state(pcfg)
            psrc = cli_evaluate.make_test_source(pcfg)
            for fn in COUNTERS.values():
                fn.launches = 0
            for i in range(2):
                hold_dense_render(task, model, psrc.get(i),
                                  "det_driver predict")
            check_launches(f"predict {task}", {"dense_attention_fwd": 24})
            with contextlib.redirect_stdout(io.StringIO()):
                written = cli_predict.main(pargv + [
                    "--idx", "0,1", "--out-dir",
                    os.path.join(tmp, f"pred_{task}")])
            if len(written) != (2 if task == "segmentation" else 4):
                raise AssertionError(f"cli.predict {task} wrote {written}")
            del model

        # the RN50-FPN through the same trainer, one epoch
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rn50 = build_trainer(det_driver_config(root, os.path.join(tmp, "rn"),
                                               "resnet50", 1))
        t0 = time.perf_counter()
        rn50.fit()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_launches("det_driver rn50", {})
        lines = [json.loads(ln) for ln in
                 Path(rn50.logger.jsonl_path).read_text().splitlines()]
        step = [p for p in lines if "step" in p]
        if len(step) != 1 or not np.isfinite(step[0]["loss"]):
            raise AssertionError(f"RN50 driver losses {step}")
        if rn50.model.image_size != TV_CANVAS or \
                rn50.train_loader.source.resize != "torchvision":
            raise AssertionError("the RN50 driver's canvas or placement")
        print(f"[det_driver] RN50-FPN {TV_CANVAS} px (torchvision "
              f"placement), one epoch: step_time_ms "
              f"{step[0]['step_time_ms']:.2f} over {step[0]['step']} steps "
              f"(its first included), loss {step[0]['loss']:.4f}; the bare "
              f"step (det_rn50 path) {DET_MS_STEP['resnet50']:.2f} ms/step; "
              f"the epoch with val, test and "
              f"the save {dt:.2f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
              f"[{card}]", flush=True)
    return measured


# ------------------------------------------------------------ multi-GPU

MGPU_WARMUP, MGPU_TIMED = 2, 3      # (a): the driver's 5 train batches
MGPU_RANK_STEPS = 3                 # (b): 1 warm-up + 2 timed, each leg
MGPU_LOSS_TOL = 2 ** -6             # a bf16 step's loss, relative
# the two-rank legs: DDP, tensor parallelism over both ranks, FSDP2 (gloo
# carries FSDP's reduce-scatter and all-gather on CUDA tensors)
MGPU_LEGS = {"dp": {}, "tp2": {"tensor_parallel": 2}, "fsdp": {"fsdp": True}}
MGPU_TIMEOUT = 600


def mgpu_steps(trainer, n_steps: int, warmup: int):
    """`n_steps` full steps of `trainer` on its first train batches at
    epoch 1's generators; (losses, ms/step over the steps after
    `warmup`, launches per step of every kernel that ran)."""
    dev = trainer.device
    aug_gen, model_gen = trainer.generators(1)
    for fn in COUNTERS.values():
        fn.launches = 0
    losses = []
    it = prefetch_to_device(trainer.train_loader.epoch(1), dev)
    for step in range(n_steps):
        if step == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        batch = next(it)
        losses.append(trainer.full_step(trainer.model, trainer.optimizer,
                                        batch["image"], batch["label"],
                                        aug_gen, model_gen)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (n_steps - warmup) * 1e3
    per_step = {name: fn.launches / n_steps for name, fn in COUNTERS.items()
                if fn.launches}
    return [float(x) for x in losses], ms, per_step


def mgpu_expect(tag: str, per_step: dict, want: dict) -> None:
    print(f"[mgpu] {tag}: launches per step {per_step} (expected {want})",
          flush=True)
    if per_step != want:
        raise AssertionError(f"{tag}: the step did not run through the "
                             f"kernels as expected: {per_step} != {want}")


def mgpu_fused_mlp_tp() -> dict:
    """MAE's encoder MLP (768 -> 3072 over MAE_B x 50 tokens, bf16) through
    the fused route (#8/#9) under TP over the two ranks, 1536 hidden units
    a rank with a zero fc2 bias and the bias added after the sum, against
    the whole MLP unfused (cuBLAS) on the same input: the output's and the
    input gradient's largest error relative to the largest value, and the
    launches."""
    from torch import nn
    from ssl4gie_tpu_torch.parallel.tp import make_place_fn, make_tp_mesh
    dev = torch.device("cuda")
    whole = layers.Mlp(768, 3072, dtype=torch.bfloat16)
    whole.reset_parameters(torch.Generator().manual_seed(SEED))
    model = nn.Module()
    model.blocks = nn.ModuleList([nn.Module()])
    model.blocks[0].mlp = copy.deepcopy(whole)
    whole.to(dev)
    make_place_fn(make_tp_mesh(2), tp=True)(model.to(dev))
    x = torch.randn((MAE_B, 50, 768), generator=torch.Generator().manual_seed(
        SEED + 1)).to(dev, torch.bfloat16)
    for fn in COUNTERS.values():
        fn.launches = 0
    fused, layers.FUSED_MLP = layers.FUSED_MLP, True
    try:
        xt = x.clone().requires_grad_()
        y = model.blocks[0].mlp(xt)
        y.float().square().mean().backward()
    finally:
        layers.FUSED_MLP = fused
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in COUNTERS.items()
                if fn.launches}
    xr = x.clone().requires_grad_()
    yr = whole(xr)
    yr.float().square().mean().backward()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    return {"launches": launches, "err_y": rel(y, yr),
            "err_dx": rel(xt.grad, xr.grad),
            "hidden": model.blocks[0].mlp.fc1.weight.shape[0]}


def mgpu_worker(rank: int, port: int, out: str) -> None:
    """One of two ranks on the one card, over gloo with CUDA tensors: the
    classification trainer of (a) built by `build_trainer` under a group
    of two, as DP (32 images a rank of the global 64), as TP over two
    ranks (6 heads a rank, the whole batch) and as FSDP2 (32 images a
    rank), a few steps each; writes the losses, ms/step and launches per
    step to `out`."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    res = {}
    for leg, runtime in MGPU_LEGS.items():
        with tempfile.TemporaryDirectory() as tmp:
            cfg = driver_config(tmp, 1)
            for k, v in runtime.items():
                setattr(cfg.runtime, k, v)
            trainer = build_trainer(cfg)
            losses, ms, per_step = mgpu_steps(trainer, MGPU_RANK_STEPS, 1)
            heads = {m.num_heads // m.tp_size for m in trainer.model.modules()
                     if isinstance(m, layers.Attention)}
            res[leg] = {"losses": losses, "ms": ms, "launches": per_step,
                        "heads_per_rank": sorted(heads),
                        "model": type(trainer.model).__name__}
            del trainer
            torch.cuda.empty_cache()
    res["fused_mlp_tp2"] = mgpu_fused_mlp_tp()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def multi_gpu_path(card: str) -> dict:
    """(a) DDP through NCCL at world size 1: `build_trainer`'s ViT-B/16
    classification trainer (B=64) under a one-rank group, against the
    same trainer without a group, on the same weights, batches and
    generators; (c) the ViT-B detection step at 1024 px under DDP at
    world size 1; (b) two ranks on the one card over gloo (DP, TP and
    FSDP legs, `mgpu_worker`), held to (a)'s world-size-1 step."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel
    from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
    from ssl4gie_tpu_torch.core.mesh import make_mesh
    from ssl4gie_tpu_torch.parallel.tp import make_place_fn
    n_steps = MGPU_WARMUP + MGPU_TIMED
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        plain = build_trainer(driver_config(tmp, 1))
        depth = len(plain.model.backbone.blocks)
        want = {"dense_attention_fwd": depth, "dense_attention_bwd": depth,
                "shear_rotate": 1}
        p_losses, p_ms, p_launch = mgpu_steps(plain, n_steps, MGPU_WARMUP)
        mgpu_expect("(a) no group", p_launch, want)
        p_state = host_copy(plain.model.state_dict())
        del plain
        torch.cuda.empty_cache()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            ddp = build_trainer(driver_config(tmp, 1))
            if not isinstance(ddp.model, DistributedDataParallel):
                raise AssertionError(f"not DDP: {type(ddp.model)}")
            d_losses, d_ms, d_launch = mgpu_steps(ddp, n_steps, MGPU_WARMUP)
            mgpu_expect("(a) DDP, NCCL, world 1", d_launch, want)
            launches.update({f"{k}_mgpu_ddp": v for k, v in d_launch.items()})
            d_state = ckpt_lib.state_dicts(ddp.model)[0]
            del ddp
            torch.cuda.empty_cache()
            print(f"[mgpu] (a) losses without a group {p_losses}, under DDP "
                  f"{d_losses}", flush=True)
            diff = max((d_state[k].float() - v.float()).abs().max().item()
                       for k, v in p_state.items())
            same = d_losses == p_losses and diff == 0.0
            print(f"[mgpu] (a) DDP at world size 1 against no group: "
                  f"{'bitwise' if same else 'not bitwise'}; largest "
                  f"parameter difference after {n_steps} steps {diff:.3g} "
                  f"(DDP averages the gradient over one rank in its "
                  f"buckets: the same sums)", flush=True)
            if not same:
                raise AssertionError(f"DDP at world size 1 differs: losses "
                                     f"{d_losses} vs {p_losses}, {diff}")
            print(f"[mgpu] (a) ViT-B/16 classification step, B={B}: "
                  f"{p_ms:.2f} ms/step without a group, {d_ms:.2f} ms/step "
                  f"under DDP (NCCL, world 1), mean of {MGPU_TIMED} after "
                  f"{MGPU_WARMUP}  [{card}]", flush=True)

            # (c) the detection step under DDP at world size 1
            model, _, full_step, batch, gen = det_setup()
            n_windowed = sum(b.attn.window_size is not None
                             for b in model.backbone.blocks)
            n_global = len(model.backbone.blocks) - n_windowed
            model = make_place_fn(make_mesh(device="cuda"))(model)
            optimizer = make_adamw(model.parameters(), LR)
            for fn in COUNTERS.values():
                fn.launches = 0
            det_losses = []
            for step in range(DET_WARMUP_STEPS + DET_TIMED_STEPS):
                if step == DET_WARMUP_STEPS:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                det_losses.append(float(full_step(model, optimizer, batch,
                                                  gen)["loss"]))
            torch.cuda.synchronize()
            det_ms = (time.perf_counter() - t0) / DET_TIMED_STEPS * 1e3
            steps = DET_WARMUP_STEPS + DET_TIMED_STEPS
            per_step = {name: fn.launches / steps
                        for name, fn in COUNTERS.items() if fn.launches}
            mgpu_expect("(c) ViT-B detection under DDP, world 1", per_step,
                        {"window_attention_fwd": n_windowed,
                         "window_attention_bwd": n_windowed,
                         "flash_attention_fwd": n_global,
                         "flash_attention_bwd": n_global})
            launches.update({f"{k}_mgpu_det": v for k, v in per_step.items()})
            if not all(np.isfinite(det_losses)):
                raise AssertionError(f"non-finite detection loss "
                                     f"{det_losses}")
            print(f"[mgpu] (c) ViT-B Faster R-CNN {DET_IMG} px, B={DET_B}, "
                  f"under DDP (NCCL, world 1): {det_ms:.2f} ms/step (bare "
                  f"step {DET_MS_STEP.get('vit_b', float('nan')):.2f}), "
                  f"losses {det_losses}  [{card}]", flush=True)
            del model, optimizer
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # (b) two ranks on the one card over gloo
        with socket_port() as port:
            pass
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--mgpu-rank", str(r), "--mgpu-port",
                                   str(port), "--mgpu-out", tmp])
                 for r in range(2)]
        try:
            rcs = [p.wait(timeout=MGPU_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if rcs != [0, 0]:
            raise AssertionError(f"the two-rank legs failed: {rcs}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(2)]
    for leg, runtime in MGPU_LEGS.items():
        for r, res in enumerate(ranks):
            got = res[leg]
            mgpu_expect(f"(b) {leg} rank {r}", got["launches"], want)
            launches.update({f"{k}_mgpu_{leg}": v
                             for k, v in got["launches"].items()})
            heads = HEADS // runtime.get("tensor_parallel", 1)
            if got["heads_per_rank"] != [heads]:
                raise AssertionError(f"{leg}: {got['heads_per_rank']} heads "
                                     f"a rank, not {heads}")
            err = abs(got["losses"][0] - p_losses[0]) / abs(p_losses[0])
            print(f"[mgpu] (b) {leg} rank {r} ({got['model']}, "
                  f"{got['heads_per_rank'][0]} heads a rank): losses "
                  f"{got['losses']}, first against world 1's "
                  f"{p_losses[0]:.6f}: rel {err:.3g}; {got['ms']:.2f} "
                  f"ms/step (mean of {MGPU_RANK_STEPS - 1} after 1; both "
                  f"ranks on one card, gloo through the host)  [{card}]",
                  flush=True)
            if not np.isfinite(got["losses"]).all() or err > MGPU_LOSS_TOL:
                raise AssertionError(f"{leg} rank {r}: loss {got['losses']} "
                                     f"vs {p_losses[0]}")
    for r, res in enumerate(ranks):
        got = res["fused_mlp_tp2"]
        print(f"[mgpu] (b) fused MLP under TP, rank {r}: {got['hidden']} "
              f"hidden units a rank, launches {got['launches']}, against "
              f"the whole MLP unfused: output {got['err_y']:.3g}, input "
              f"gradient {got['err_dx']:.3g} of the largest value",
              flush=True)
        if (got["launches"] != {"fused_mlp_fwd": 1, "fused_mlp_bwd": 1}
                or got["hidden"] != 1536
                or max(got["err_y"], got["err_dx"]) > MGPU_LOSS_TOL):
            raise AssertionError(f"fused MLP under TP, rank {r}: {got}")
        launches.update({f"{k}_encoder_mgpu_tp2_fused": v
                         for k, v in got["launches"].items()})
    return launches


# ------------------------------------------- float32 compute and Dh 80
# ViT-H: MAE's own per-GPU batch (`--batch_size 64`, Models/mae/
# main_pretrain.py); the recipe's mask ratio and one whose kept tokens
# (1 + int(256 * 0.7) = 180) reach the packed-QKV range
VIT_H_B, VIT_H_MASKS = 64, (0.75, 0.3)
VIT_H_WARMUP, VIT_H_TIMED = 1, 2
VIT_H_LOSS_TOL = 0.01        # bf16 on the card against f32 on the CPU
# the float32 ViT-H step: cut in depth (the kernels' shapes are a block's)
VIT_H_F32_B, VIT_H_F32_DEPTH = 8, 4
F32_WARMUP, F32_TIMED = 1, 3
F32_NOTE = "--compute-dtype float32 (f32 compute over f32 masters)"


def check_f32(name, got, ref, tol: float) -> float:
    """Max |got - ref|; raise unless every element is finite and within
    tol * max|ref| (the float32 instances' limit)."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    if err > tol * ref.abs().max().item():
        raise AssertionError(f"{name}: kernel disagrees with the plain version:"
                             f" max|err|={err:.4g}, max|ref|="
                             f"{ref.abs().max().item():.4g} (tol {tol:g})")
    return err


def held_instance(base: str, sfx: str, what: str, src: str, replaces,
                  dtype, fwd, bwd, plain_fwd, plain_bwd, plain_graph,
                  sdpa_in, scale: float, work_f, work_b,
                  card: str) -> list[dict]:
    """One instance of an attention kernel against its plain version on the
    card: float32 outputs within F32_OUT_TOL and gradients within
    F32_GRAD_TOL of the largest value, bf16 within two bf16 ulps (2^-6), the
    log-sum-exp within 2^-16; timed beside the plain version, SDPA in the
    same dtype and the bound at the dtype's peak. `fwd()` gives (out, lse),
    `bwd(out, lse)` the gradients (None: a forward-only row),
    `plain_graph()` (output, inputs, dout) of a recorded plain forward,
    `sdpa_in` contiguous (B, H, N, Dh) q, k, v and dO. Rows
    `<base>_fwd<sfx>` and `<base>_bwd<sfx>`."""
    f32 = dtype == torch.float32
    peak, tol_f, tol_b = ((PEAK_F32_FLOPS, F32_OUT_TOL, F32_GRAD_TOL) if f32
                          else (PEAK_FLOPS, 2.0 ** -6, 2.0 ** -6))
    close = check_f32 if f32 else check_close
    out, lse = fwd()
    torch.cuda.synchronize()
    out_p, lse_p = plain_fwd()
    err_f = close(f"{base}_fwd{sfx}", out, out_p, tol_f)
    check_close(f"{base}_fwd{sfx} lse", lse, lse_p, 2.0 ** -16)
    del out_p, lse_p
    q, k, v, do = sdpa_in
    rows = [result(f"{base}_fwd{sfx}", src, replaces[0], err_f,
                   cuda_ms(fwd), cuda_ms(plain_fwd), sdpa_ms(q, k, v, scale),
                   *work_f, peak=peak)]
    if bwd is not None:
        grads = bwd(out, lse)
        torch.cuda.synchronize()
        err_b = max(close(f"{base}_bwd{sfx}", g, r, tol_b)
                    for g, r in zip(grads, plain_bwd()))
        del grads
        o, xs, dout = plain_graph()
        plain_ms = cuda_ms(lambda: torch.autograd.grad(o, xs, dout,
                                                       retain_graph=True))
        del o, xs
        rows.append(result(f"{base}_bwd{sfx}", src, replaces[1], err_b,
                           cuda_ms(lambda: bwd(out, lse)), plain_ms,
                           sdpa_ms(q, k, v, scale, do), *work_b, peak=peak))
    del out, lse
    dt = "f32" if f32 else "bf16"
    print(f"[kernel] {base}{sfx} {what} {dt}: max|err| "
          + " / ".join(f"{r['max_abs_err']:.3g}" for r in rows)
          + f" (tol {tol_f:g} / {tol_b:g}{' of max' if f32 else ' rel'}); "
          + "; ".join(f"{r['name']}: kernel {r['ms']:.4f} ms ("
                      f"{tflops(w[0], r['ms'])}), plain {r['plain_ms']:.4f} "
                      f"ms, sdpa {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                      f"{r['bound_peak_tflops']:g} TFLOP/s)"
                      for r, w in zip(rows, (work_f, work_b)))
          + f"  [{card}]", flush=True)
    return rows


def dense_instance(sfx: str, seqs: int, n: int, heads: int, dh: int,
                   dtype, gen, card: str) -> list[dict]:
    """#1/#2 at (seqs, n, 3 * heads * dh) in `dtype`."""
    C, scale = heads * dh, dh ** -0.5
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device="cuda").to(dtype)
    qkv, dout = rand(seqs, n, 3 * C), rand(seqs, n, C)
    item = dout.element_size()

    def graph():
        x = qkv.detach().requires_grad_(True)
        return da.fused_qkv_attention_plain(x, heads, scale), [x], dout

    return held_instance(
        "dense_attention", sfx, f"B={seqs} N={n} H={heads} Dh={dh}",
        "dense_attention.cu", ("ssl4gie_tpu/kernels/dense_attention.py:146",
                               "ssl4gie_tpu/kernels/dense_attention.py:169"),
        dtype, lambda: da.attention_fwd(qkv, heads, scale),
        lambda o, l: (da.attention_bwd(qkv, o, l, dout, heads, scale),),
        lambda: da.fused_qkv_attention_fwd_plain(qkv, heads, scale),
        lambda: (da.fused_qkv_attention_bwd_plain(qkv, dout, heads, scale),),
        graph, (*heads_of(qkv, heads), split_heads(dout, heads)), scale,
        attn_work(seqs, heads, n, dh, False, item),
        attn_work(seqs, heads, n, dh, True, item), card)


def window_instance(sfx: str, batch: int, backward: bool, gen,
                    card: str) -> list[dict]:
    """#4/#5 in float32 on the (batch, 64, 64, 3 * 768) grid, 16 x 16
    windows (the backward only when `backward`)."""
    C, scale = HEADS * HEAD_DIM, HEAD_DIM ** -0.5
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    qkv, dout = rand(batch, DET_GRID, DET_GRID, 3 * C), rand(
        batch, DET_GRID, DET_GRID, C)
    args = (HEADS, DET_WINDOW, scale)
    n_win = batch * (DET_GRID // DET_WINDOW) ** 2

    def graph():
        x = qkv.detach().requires_grad_(True)
        return wa.windowed_attention_plain(x, *args), [x], dout

    return held_instance(
        "window_attention", sfx,
        f"B={batch} grid {DET_GRID}x{DET_GRID} window {DET_WINDOW} "
        f"H={HEADS} Dh={HEAD_DIM}", "window_attention.cu",
        ("ssl4gie_tpu/kernels/window_attention.py:97",
         "ssl4gie_tpu/kernels/window_attention.py:124"), torch.float32,
        lambda: wa.window_attention_fwd(qkv, *args),
        (lambda o, l: (wa.window_attention_bwd(qkv, o, l, dout, *args),))
        if backward else None,
        lambda: wa.windowed_attention_fwd_plain(qkv, *args),
        lambda: (wa.windowed_attention_bwd_plain(qkv, dout, *args),),
        graph, (*heads_of(wa.partition(qkv, DET_WINDOW), HEADS),
                split_heads(wa.partition(dout, DET_WINDOW), HEADS)), scale,
        attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, False, 4),
        attn_work(n_win, HEADS, DET_WINDOW ** 2, HEAD_DIM, True, 4), card)


def flash_instance(sfx: str, batch: int, backward: bool, gen,
                   card: str) -> list[dict]:
    """#6/#7 in float32 at (batch * 12, 4096, 64) (the backward only when
    `backward`)."""
    bh, scale = batch * HEADS, HEAD_DIM ** -0.5
    q, k, v, do = (torch.randn((bh, DET_N, HEAD_DIM), generator=gen,
                               device="cuda") for _ in range(4))
    nbytes = lambda n_in, n_out: ((n_in + n_out) * bh * DET_N * HEAD_DIM * 4
                                  + bh * DET_N * 4)
    flops = bh * DET_N * DET_N * HEAD_DIM
    bhnd = lambda t: t.view(batch, HEADS, DET_N, HEAD_DIM)

    def graph():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return fa.flash_attention_plain(*xs, scale), xs, do

    return held_instance(
        "flash_attention", sfx, f"BH={bh} N={DET_N} D={HEAD_DIM}",
        "flash_attention.cu", ("ssl4gie_tpu/kernels/flash_attention.py:146",
                               "ssl4gie_tpu/kernels/flash_attention.py:182"),
        torch.float32, lambda: fa.flash_fwd(q, k, v, scale),
        (lambda o, l: fa.flash_bwd(q, k, v, o, l, do, scale))
        if backward else None,
        lambda: fa.flash_attention_fwd_plain(q, k, v, scale),
        lambda: fa.flash_attention_bwd_plain(q, k, v, do, scale),
        graph, (bhnd(q), bhnd(k), bhnd(v), bhnd(do)), scale,
        (4 * flops, nbytes(3, 1)), (10 * flops, nbytes(5, 3)), card)


def f32_kernel_phase(card: str) -> list[dict]:
    """The float32 instances of #1/#2 (Dh 64 at the classification shape,
    Dh 32 at the MAE decoder's, Dh 80 at the MAE ViT-H encoder's at mask
    0.3), #4/#5 and #6/#7 (the detection shapes and the eval batch's
    forwards, the masked flash cases), and the bf16 Dh-80 instance of
    #1/#2, each against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = dense_instance("_f32", B, TOKENS, HEADS, HEAD_DIM, torch.float32,
                          gen, card)
    rows += dense_instance("_f32_dh32", MAE_B, TOKENS, MAE_DEC_HEADS,
                           MAE_DEC_DIM // MAE_DEC_HEADS, torch.float32, gen,
                           card)
    vit_h = MAE_SIZES["vit_h"]
    n_h, heads_h = 1 + int(256 * (1 - VIT_H_MASKS[1])), vit_h["num_heads"]
    dh_h = vit_h["embed_dim"] // heads_h
    for sfx, dt in (("_f32_dh80", torch.float32), ("_dh80", torch.bfloat16)):
        rows += dense_instance(sfx, VIT_H_B, n_h, heads_h, dh_h, dt, gen,
                               card)
    rows += window_instance("_f32", DET_B, True, gen, card)
    rows += window_instance("_f32_eval", EVAL_B, False, gen, card)
    rows += flash_instance("_f32", DET_B, True, gen, card)
    rows += flash_instance("_f32_eval", EVAL_B, False, gen, card)
    scale = HEAD_DIM ** -0.5
    q, k, v, do = (torch.randn((DET_BH, 1024, HEAD_DIM), generator=gen,
                               device="cuda") for _ in range(4))
    for n_valid in (1000, 3):
        o_k, lse_k = fa.flash_fwd(q, k, v, scale, n_valid)
        grads = fa.flash_bwd(q, k, v, o_k, lse_k, do, scale, n_valid)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, n_valid)
        err = check_f32("flash_fwd_f32 masked", o_k, o_p, F32_OUT_TOL)
        check_close("flash_fwd_f32 masked lse", lse_k, lse_p, 2.0 ** -16)
        err = max([err] + [
            check_f32(f"flash_bwd_f32 masked d{n}", g, r, F32_GRAD_TOL)
            for n, g, r in zip("qkv", grads, fa.flash_attention_bwd_plain(
                q, k, v, do, scale, n_valid))])
        print(f"[kernel] flash f32 masked BH={DET_BH} N=1024 n_valid="
              f"{n_valid}: fwd and bwd max|err|={err:.3g} (tol "
              f"{F32_OUT_TOL:g} / {F32_GRAD_TOL:g} of max)  [{card}]",
              flush=True)
    return rows


def f32_cls_path(card: str) -> dict:
    """`build_trainer` on DRIVER_ARGV + --compute-dtype float32 (ViT-B/16,
    224 px, B=64), a few full steps on its first train batches, twice from
    the same seed: exactly 12 float32 #1, 12 float32 #2 and one bf16 #3 a
    step, no bf16 attention launch; finite losses; the two runs' parameters
    and losses bitwise equal; the logits within F32_MODEL_TOL of the
    largest against a float32 CPU run of the same weights at B=2."""
    n_steps = F32_WARMUP + F32_TIMED
    runs = []
    with tempfile.TemporaryDirectory(prefix="ssl4gie_f32_") as tmp:
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = build_trainer(driver_config(
                tmp, 1, ["--compute-dtype", "float32"]))
            depth = len(trainer.model.backbone.blocks)
            losses, ms, per_step = mgpu_steps(trainer, n_steps, F32_WARMUP)
            want = {"dense_attention_fwd_f32": depth,
                    "dense_attention_bwd_f32": depth, "shear_rotate": 1}
            mgpu_expect("f32_cls", per_step, want)
            if not all(np.isfinite(losses)):
                raise AssertionError(f"non-finite float32 loss: {losses}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[f32_cls] ViT-B/16 224 px finetune step, B={B}, "
                  f"{F32_NOTE}: {ms:.2f} ms/step, "
                  f"{B / ms * 1e3:.1f} img/s (mean of {F32_TIMED} after "
                  f"{F32_WARMUP}), peak memory {peak:.2f} GiB; losses "
                  f"{losses}  [{card}]", flush=True)
            runs.append((losses, host_copy(trainer.model.state_dict())))
            model = trainer.model
            del trainer
    _equal_states(runs[0][1], runs[1][1], "f32 classification rerun")
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"float32 reruns' losses differ: {runs}")
    print(f"[f32_cls] two runs from seed {SEED}: parameters and losses "
          f"bitwise equal after {n_steps} steps", flush=True)
    del runs
    rng = np.random.default_rng(SEED)
    x = eval_batch(torch.from_numpy(rng.integers(
        0, 256, (2, IMG, IMG, 3), dtype=np.uint8)).cuda())
    model.eval()
    with torch.no_grad():
        logits = model(x).float().cpu()
        ref_model = ViTClassifier(NUM_CLASSES, dtype=torch.float32,
                                  device="cpu")
        ref_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        ref = ref_model.eval()(x.cpu())
    err, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
    print(f"[f32_cls] logits f32 on card vs f32 on CPU (B=2): max|err|="
          f"{err:.4g}, max|ref|={scale:.4g} (tol {F32_MODEL_TOL:g} of max)",
          flush=True)
    if not bool(torch.isfinite(logits).all()) or err > F32_MODEL_TOL * scale:
        raise AssertionError(f"float32 logits disagree: {err} > "
                             f"{F32_MODEL_TOL} * {scale}")
    return {"dense_attention_fwd_f32": depth * n_steps,
            "dense_attention_bwd_f32": depth * n_steps}


def f32_det_path(card: str) -> dict:
    """`build_trainer` on a `cli/train.py --task detection --arch vit_b
    --compute-dtype float32` command line over Kvasir-layout frames
    (1024 px, B=4), a few full steps: exactly 8 + 8 float32 window and
    4 + 4 float32 flash launches a step and nothing else; finite losses;
    one eval forward at EVAL_B (8 + 4 float32 forwards); the backbone map
    within F32_MODEL_TOL of the largest against a float32 CPU run of the
    same weights at 512 px."""
    dev = torch.device("cuda")
    n_steps = DET_WARMUP_STEPS + DET_TIMED_STEPS
    with tempfile.TemporaryDirectory(prefix="ssl4gie_f32_det_") as tmp:
        root = os.path.join(tmp, "kvasir")
        write_kvasir(root)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(det_driver_config(
            root, tmp, "vit_b", 1, ["--compute-dtype", "float32"]))
        model = trainer.model
        n_windowed = sum(b.attn.window_size is not None
                         for b in model.backbone.blocks)
        n_global = len(model.backbone.blocks) - n_windowed
        aug_gen, model_gen = trainer.generators(1)
        it = prefetch_to_device(trainer.train_loader.epoch(1), dev)
        for fn in COUNTERS.values():
            fn.launches = 0
        losses = []
        for step in range(n_steps):
            if step == DET_WARMUP_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            batch = next(it)
            losses.append(trainer.full_step(model, trainer.optimizer, batch,
                                            aug_gen, model_gen))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del it
    ran = check_launches("det_f32", {
        "window_attention_fwd_f32": n_windowed * n_steps,
        "window_attention_bwd_f32": n_windowed * n_steps,
        "flash_attention_fwd_f32": n_global * n_steps,
        "flash_attention_bwd_f32": n_global * n_steps})
    losses = [{k: float(v) for k, v in d.items()} for d in losses]
    print(f"[det_f32] losses: {losses}", flush=True)
    if not all(np.isfinite(list(d.values())).all() for d in losses):
        raise AssertionError(f"non-finite float32 detection loss: {losses}")
    print(f"[det_f32] ViT-B Faster R-CNN {DET_IMG} px train step, B={DET_B}, "
          f"{F32_NOTE}: {dt / DET_TIMED_STEPS * 1e3:.2f} "
          f"ms/step, {DET_B * DET_TIMED_STEPS / dt:.2f} img/s (mean of "
          f"{DET_TIMED_STEPS} after {DET_WARMUP_STEPS}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
          flush=True)

    model.eval()
    for fn in COUNTERS.values():
        fn.launches = 0
    with torch.no_grad():
        det = model(batch["image"][:EVAL_B].to(torch.float32) / 255.0)
    torch.cuda.synchronize()
    check_launches("det_f32 eval", {"window_attention_fwd_f32": n_windowed,
                                    "flash_attention_fwd_f32": n_global})
    if not bool(torch.isfinite(det["boxes"]).all()):
        raise AssertionError("non-finite float32 detections")

    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    ref_model = FasterRCNN(image_size=DET_REF_IMG, dtype=torch.float32,
                           device="cpu")
    ref_model.load_state_dict(sd)
    small = copy.deepcopy(ref_model).to(dev).eval()
    x = normalize(batch["image"][:1, :DET_REF_IMG, :DET_REF_IMG]
                  .to(torch.float32) / 255.0)
    with torch.no_grad():
        fmap = small.backbone(x).cpu()
        ref = ref_model.eval().backbone(x.cpu())
    err, scale = (fmap - ref).abs().max().item(), ref.abs().max().item()
    print(f"[det_f32] backbone map ({DET_REF_IMG} px) f32 on card vs f32 on "
          f"CPU: max|err|={err:.4g}, max|ref|={scale:.4g} (tol "
          f"{F32_MODEL_TOL:g} of max)", flush=True)
    if not bool(torch.isfinite(fmap).all()) or err > F32_MODEL_TOL * scale:
        raise AssertionError(f"float32 backbone maps disagree: {err} > "
                             f"{F32_MODEL_TOL} * {scale}")
    return {**ran, "window_attention_fwd_f32_eval": n_windowed,
            "flash_attention_fwd_f32_eval": n_global}


def mae_loss_vs_cpu(tag: str, run, img_u8, tol: float, gen) -> None:
    """The run's loss on the card against a float32 CPU MAE of the same
    weights on the same crops and masking noise (B=2), relative."""
    model = run.model
    imgs = mae_augment(img_u8[:2], sample_mae_params(2, gen, MAE_CANVAS))
    noise = model.draw_noise(2, gen)
    with torch.no_grad():
        loss = float(model(imgs, noise)[0])
        size = dict(MAE_SIZES[run.cfg.architecture.value],
                    **run.cfg.model_kwargs)
        ref_model = MAE(img_size=run.cfg.img_size,
                        mask_ratio=run.cfg.mask_ratio,
                        norm_pix_loss=run.cfg.norm_pix_loss,
                        dtype=torch.float32, device="cpu", **size)
        ref_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        ref = float(ref_model(imgs.cpu(), noise.cpu())[0])
    rel = abs(loss - ref) / abs(ref)
    print(f"[{tag}] loss on card {loss:.9g} vs f32 on CPU {ref:.9g} (B=2, "
          f"same weights, crops and mask): relative difference {rel:.3g} "
          f"(tol {tol:g})", flush=True)
    if not (np.isfinite(loss) and rel <= tol):
        raise AssertionError(f"{tag}: loss {loss} vs {ref} on the CPU")


def vit_h_run(tag: str, argv: list, batch: int, card: str, img_u8,
              model_kwargs=None):
    """`build_pretraining` for `cli/pretrain.py --framework mae --arch vit_h`
    plus `argv` at `batch`, a few steps on one resident batch; (run,
    launches over the steps by counter, steps, the generator)."""
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ssl4gie_vit_h_") as tmp:
        cfg = pretrain_config("mae", "vit_h", tmp, batch,
                              ["--batch-size", str(batch), *argv])
        cfg.model_kwargs = dict(model_kwargs or {})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = build_pretraining(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for fn in COUNTERS.values():
        fn.launches = 0
    hist = []
    warmup, timed = VIT_H_WARMUP, VIT_H_TIMED
    for step in range(warmup + timed):
        if step == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        hist.append(run.full_step(run.model, run.optimizer, img_u8[:batch],
                                  gen, step))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hist = [{k: float(v) for k, v in h.items()} for h in hist]
    if not all(np.isfinite(list(h.values())).all() for h in hist):
        raise AssertionError(f"{tag}: non-finite loss or gradient norm "
                             f"{hist}")
    print(f"[{tag}] MAE ViT-H/14 224 px pretraining step ({' '.join(argv)}"
          f"{', depth ' + str(len(run.model.blocks)) if model_kwargs else ''}"
          f"), B={batch}: {dt / timed * 1e3:.2f} ms/step, "
          f"{batch * timed / dt:.1f} img/s (mean of {timed} after {warmup}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"loss / grad_norm {hist}  [{card}]", flush=True)
    return run, warmup + timed, gen


def vit_h_path(card: str) -> dict:
    """The MAE ViT-H/14 (1280 wide, 32 blocks of 16 heads of 80; decoder
    512 wide, 8 blocks of 16 heads of 32) built by `build_pretraining` from
    `cli/pretrain.py`'s config at B=64, bf16 over f32 masters: at
    --mask-ratio 0.75 the encoder's 65 tokens take plain attention and only
    the decoder's 8 + 8 Dh-32 launches a step run; at 0.3 (180 tokens) also
    32 + 32 Dh-80 launches. Finite losses; at 0.3 the loss within 1% of a
    float32 CPU run of the same weights, crops and mask at B=2. Then the
    same config with --compute-dtype float32 at B=8, the encoder cut to 4
    blocks: 4 + 4 float32 Dh-80 and 8 + 8 float32 Dh-32 launches a step,
    its loss within F32_MODEL_TOL of the CPU run's."""
    src = SyntheticUnlabeled(VIT_H_B, canvas=MAE_CANVAS, seed=SEED)
    img_u8 = torch.from_numpy(src.batch(range(VIT_H_B))["image"]).cuda()
    launches = {}
    for ratio in VIT_H_MASKS:
        tag = f"vit_h_mask{ratio}"
        run, n, gen = vit_h_run(tag, ["--mask-ratio", str(ratio)], VIT_H_B,
                                card, img_u8)
        enc, dec = len(run.model.blocks), len(run.model.decoder_blocks)
        kept = 1 + int(run.model.num_patches * (1 - ratio))
        routed = layers.FUSED_MIN_SEQ <= kept <= da.MAX_FUSED_SEQ
        ran = check_launches(tag, {
            "dense_attention_fwd": (dec + enc * routed) * n,
            "dense_attention_bwd": (dec + enc * routed) * n,
            "dense_attention_fwd_dh80": enc * routed * n,
            "dense_attention_bwd_dh80": enc * routed * n})
        print(f"[{tag}] encoder on {kept} tokens "
              f"({'the packed-QKV kernel at Dh 80' if routed else 'plain'})"
              f", decoder on {run.model.num_patches + 1} (Dh 32)", flush=True)
        if routed:
            mae_loss_vs_cpu(tag, run, img_u8, VIT_H_LOSS_TOL, gen)
            launches.update({k: v for k, v in ran.items()
                             if k.endswith("_dh80")})
        del run
        torch.cuda.empty_cache()
    tag = "vit_h_f32"
    run, n, gen = vit_h_run(tag, ["--mask-ratio", str(VIT_H_MASKS[1]),
                                  "--compute-dtype", "float32"],
                            VIT_H_F32_B, card, img_u8,
                            {"depth": VIT_H_F32_DEPTH})
    enc, dec = len(run.model.blocks), len(run.model.decoder_blocks)
    ran = check_launches(tag, {
        "dense_attention_fwd_f32": (enc + dec) * n,
        "dense_attention_bwd_f32": (enc + dec) * n,
        "dense_attention_fwd_f32_dh80": enc * n,
        "dense_attention_bwd_f32_dh80": enc * n})
    mae_loss_vs_cpu(tag, run, img_u8, F32_MODEL_TOL, gen)
    del run
    torch.cuda.empty_cache()
    launches.update({
        "dense_attention_fwd_f32_dh80": ran["dense_attention_fwd_f32_dh80"],
        "dense_attention_bwd_f32_dh80": ran["dense_attention_bwd_f32_dh80"],
        "dense_attention_fwd_f32_dh32": dec * n,
        "dense_attention_bwd_f32_dh32": dec * n})
    return launches


# the float32 policy's settings against PyTorch's defaults on the card:
# (cuDNN TF32, cuDNN deterministic)
POLICY_SETTINGS = {"policy": (False, True), "defaults": (True, False),
                   "TF32 off only": (False, False)}


def policy_cost_path(card: str) -> dict:
    """The float32 policy's cost (`float32_policy`: cuDNN's convolutions off
    TF32 and deterministic): the RN50 + DeepLabV3+ seg step of DENSE_PATHS
    at B=SEG_B, timed by CUDA events per step under the policy, under
    PyTorch's defaults (TF32 on, cuDNN free to pick nondeterministic
    algorithms) and with TF32 off alone, in turns (forward then reversed),
    under bf16 compute (its float32 seg_head) and under float32 compute.
    No kernel of the port runs in it but the rotation."""
    cudnn = torch.backends.cudnn
    try:
        for dt in (torch.bfloat16, torch.float32):
            model, opt, full_step, img_u8, targets, gen = dense_setup(
                "rn50_seg", dt)
            step = lambda: full_step(model, opt, img_u8, targets, gen)
            times = {k: [] for k in POLICY_SETTINGS}
            for key in (*POLICY_SETTINGS, *reversed(POLICY_SETTINGS)):
                cudnn.allow_tf32, cudnn.deterministic = POLICY_SETTINGS[key]
                times[key].append(cuda_ms(step, runs=3, warmup=1))
            mean = {k: statistics.mean(v) for k, v in times.items()}
            print(f"[policy] RN50 + DeepLabV3+ seg step, B={SEG_B}, "
                  f"{'bf16' if dt == torch.bfloat16 else 'f32'} compute, "
                  f"ms/step: " + ", ".join(
                      f"{k} {mean[k]:.2f} {[round(t, 2) for t in v]}"
                      for k, v in times.items())
                  + f"; the policy costs "
                  f"{mean['policy'] / mean['defaults'] - 1:+.1%} against "
                  f"the defaults  [{card}]", flush=True)
            del model, opt, step
            torch.cuda.empty_cache()
    finally:
        float32_policy()
    return {}


@contextlib.contextmanager
def socket_port():
    """A free TCP port on localhost (released on exit, for the ranks)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


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
    # one rank of the multi-GPU phase's two-rank legs (`mgpu_worker`)
    parser.add_argument("--mgpu-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mgpu-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mgpu-out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.mgpu_rank is not None:
        mgpu_worker(args.mgpu_rank, args.mgpu_port, args.mgpu_out)
        return
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
    float32_policy()       # as `build_trainer` sets it, for every phase
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
              ("kernels (float32 instances, Dh 80)", f32_kernel_phase),
              ("classification path", main_path),
              ("float32 classification path", f32_cls_path),
              *((f"{tag} path", functools.partial(dense_path, tag))
                for tag in DENSE_PATHS),
              ("detection path", det_path),
              ("float32 detection path", f32_det_path),
              ("RN50 detection path", det_rn50_path),
              ("detection eval (evaluate_map)", det_eval_path),
              ("MAE path", mae_path),
              ("MAE ViT-H path", vit_h_path),
              ("float32 policy (RN50 seg step)", policy_cost_path),
              *((f"MoCo {arch} path", functools.partial(moco_path, arch))
                for arch in MOCO_ARCHS),
              ("kernel A/B harnesses", harness_path),
              ("finetune driver", driver_path),
              ("pretrain driver", pretrain_driver_path),
              ("SSL finetune recipes", recipes_path),
              ("exact affine", exact_affine_path),
              ("detection driver", det_driver_path),
              ("multi-GPU", multi_gpu_path)]
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
        # the SSL finetune recipes' launches of the same kernel per train
        # step
        per_recipe = {name: launches[key] for name in RECIPES
                      if (key := f"{r['name']}_recipe_{name}_step")
                      in launches}
        if per_recipe:
            r["recipe_launches_per_train_step"] = per_recipe
        # the detection driver's launches of the same kernel, per train
        # step and per eval batch
        for kind in ("step", "eval"):
            key = f"{r['name'].removesuffix('_eval')}_det_driver_{kind}"
            if key in launches:
                r[f"det_driver_launches_per_{kind}"] = launches[key]
        # the multi-GPU phase's launches per step (per rank in (b))
        for leg in ("ddp", "det", *MGPU_LEGS, "tp2_fused"):
            if (key := f"{r['name']}_mgpu_{leg}") in launches:
                r[f"mgpu_{leg}_launches_per_step"] = launches[key]
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
