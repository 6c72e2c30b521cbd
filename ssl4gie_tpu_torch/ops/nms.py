"""Static-shape NMS (port of `ssl4gie_tpu/ops/nms.py`).

The exact greedy slot loop: `k` iterations of (argmax over live scores ->
suppress IoU > threshold), each a handful of vector ops over all images at
once, so the loop costs k iterations whatever the batch. Output is always k
indices and a validity mask per image; exhausted slots are invalid. This is
torchvision's greedy NMS for the top-k survivors, which is all callers
consume (RPN post_nms_top_n, detections_per_img). No value leaves the device
inside the loop. The loop runs under a profiler range "nms_topk", so a
`torch.profiler` trace shows its share of a step.
"""

from __future__ import annotations

import torch


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             k: int, valid: torch.Tensor | None = None):
    """Exact greedy NMS keeping (up to) the top-k survivors of each image.

    boxes: (B, N, 4), scores: (B, N), valid: optional (B, N) bool.
    Returns (indices (B, k) int64, out_valid (B, k) bool): indices into each
    image's N boxes in descending score order; out_valid False for exhausted
    slots. `torch.argmax` returns the first maximum, as `jnp.argmax` does.
    """
    with torch.profiler.record_function("nms_topk"):
        return _nms_topk(boxes, scores, iou_threshold, k, valid)


def _nms_topk(boxes, scores, iou_threshold, k, valid):
    B = boxes.shape[0]
    boxes = boxes.detach()
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32,
                           device=boxes.device)
    live = scores.detach().to(torch.float32)
    if valid is not None:
        live = torch.where(valid, live, neg_inf)
    # the IoU expression of `_iou_one_vs_all`, with the per-box areas hoisted
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    rows = torch.arange(B, device=boxes.device)
    idx = torch.empty((B, k), dtype=torch.int64, device=boxes.device)
    ok = torch.empty((B, k), dtype=torch.bool, device=boxes.device)
    for slot in range(k):
        i = torch.argmax(live, dim=1)                       # (B,)
        s = live[rows, i]
        box = boxes[rows, i]                                 # (B, 4)
        area1 = areas[rows, i][:, None]
        lt = torch.maximum(box[:, None, :2], boxes[..., :2])
        rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        union = area1 + areas - inter
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                          torch.zeros((), dtype=inter.dtype,
                                      device=inter.device))
        finite = torch.isfinite(s)
        # an exhausted slot (s == -inf) suppresses nothing
        live = torch.where((iou > iou_threshold) & finite[:, None], neg_inf,
                           live)
        live[rows, i] = neg_inf
        idx[:, slot] = i
        ok[:, slot] = finite
    return idx, ok


def batched_nms_topk(boxes: torch.Tensor, scores: torch.Tensor,
                     idxs: torch.Tensor, iou_threshold: float, k: int,
                     valid: torch.Tensor | None = None):
    """Class/level-aware NMS via torchvision's coordinate-offset trick, per
    image: boxes (B, N, 4), scores (B, N), idxs (B, N) or (N,) group ids."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.amax(torch.where(torch.isfinite(boxes), boxes, zero),
                           dim=(1, 2)) + 1.0
    offset = idxs.to(boxes.dtype)[..., None] * max_coord[:, None, None]
    return nms_topk(boxes + offset, scores, iou_threshold, k, valid)
