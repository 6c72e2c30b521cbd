"""Exact greedy NMS keeping the top-k survivors of each image, in one launch.

It replaces no TPU kernel: the JAX package's `ops/nms.py:nms_topk` is a
slot loop that XLA compiles into one device loop. The port's eager slot
loop (`ops/nms.py:_nms_topk`) is about twenty launches a slot, so on the
card the host's launch rate would pace every detection step (k = 1,000
slots at the RPN). On CUDA tensors `nms_topk` launches `ssl4gie_nms_topk`
(`csrc/nms.cu`: a cluster of up to 8 blocks an image runs the whole loop,
the live scores in registers, the boxes in shared memory, a slot's winner
exchanged through distributed shared memory), which returns the loop's
indices and validity bit for bit; it counts its launches in
`nms_topk.launches`.
It takes float32 boxes (B, N, 4), scores (B, N) of any float dtype (cast to
float32, as the loop casts them) and an optional bool `valid` (B, N), with
1 <= N <= MAX_CANDIDATES; anything else raises. The slot loop stays the
definition and runs on CPU tensors (`ops.nms.nms_topk` routes by device).
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.kernels import _build

MAX_CANDIDATES = 8 * 1024 * 2   # blocks x threads x candidates a thread


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             k: int, valid: torch.Tensor | None = None):
    """(idx (B, k) int64, ok (B, k) bool) of the greedy NMS of each image's
    candidates, as `ops.nms._nms_topk` gives them, from one launch of
    `ssl4gie_nms_topk` on the boxes' card."""
    if boxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel runs on CUDA tensors, got "
                         f"{boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    B, N = boxes.shape[:2]
    if boxes.dtype != torch.float32:
        raise TypeError(f"the NMS kernel takes float32 boxes, got "
                        f"{boxes.dtype}")
    if not 1 <= N <= MAX_CANDIDATES:
        raise ValueError(f"the NMS kernel takes 1 to {MAX_CANDIDATES} "
                         f"candidates an image, got {N}")
    if tuple(scores.shape) != (B, N) or (
            valid is not None and tuple(valid.shape) != (B, N)):
        raise ValueError("scores and valid must be (B, N) beside boxes "
                         f"{tuple(boxes.shape)}")
    boxes = boxes.detach().contiguous()
    if boxes.data_ptr() % 16:           # the kernel reads a box as a float4
        boxes = boxes.clone()
    scores = scores.detach().to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    for name, t in (("scores", scores), ("valid", valid)):
        if t is not None and t.device != boxes.device:
            raise ValueError(f"{name} is not on {boxes.device}")
    idx = torch.empty((B, k), dtype=torch.int64, device=boxes.device)
    ok = torch.empty((B, k), dtype=torch.bool, device=boxes.device)
    _build.launch_on(boxes.device, "ssl4gie_nms_topk", boxes.data_ptr(),
                     scores.data_ptr(),
                     None if valid is None else valid.data_ptr(),
                     idx.data_ptr(), ok.data_ptr(), B, N, k,
                     float(iou_threshold))
    nms_topk.launches += 1
    return idx, ok


nms_topk.launches = 0
