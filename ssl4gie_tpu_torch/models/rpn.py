"""Region proposal network (port of `ssl4gie_tpu/models/rpn.py`).

torchvision semantics with static shapes: multi-level anchors (sizes 32..512,
ratios 0.5/1/2), a shared 3x3 conv head, per-level pre-NMS top-k,
level-aware NMS with a fixed output count, the IoU matcher (0.7/0.3 with
low-quality matches), 256-anchor sampling at 0.5 positive fraction, BCE
objectness and smooth-L1 (beta 1/9) box loss normalized by the number
sampled. Every function takes a batch dimension where the JAX package vmaps
over images.

Sampling splits drawing from applying: `sample_balanced` takes its uniform
noise as a tensor, so the tests can feed it the JAX package's draws.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.layers import init_lecun
from ssl4gie_tpu_torch.models.vitdet_fpn import conv_nhwc
from ssl4gie_tpu_torch.ops.boxes import (box_iou, clip_to_canvas,
                                         decode_boxes, encode_boxes,
                                         small_box_mask, smooth_l1)
from ssl4gie_tpu_torch.ops.nms import batched_nms_topk

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(ASPECT_RATIOS)


def anchor_grid_info(feature_shapes: Sequence[Tuple[int, int]],
                     strides: Sequence[int]) -> np.ndarray:
    """Static per-anchor (gx, gy, stride) int32 array aligned with
    `generate_anchors`' flattening order (level-major, row-major, A-fast)."""
    rows = []
    for (h, w), stride in zip(feature_shapes, strides):
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        g = np.stack([gx.ravel(), gy.ravel()], axis=1)
        g = np.repeat(g, NUM_ANCHORS, axis=0)
        s = np.full((g.shape[0], 1), stride)
        rows.append(np.concatenate([g, s], axis=1))
    return np.concatenate(rows, axis=0).astype(np.int32)


def generate_anchors(feature_shapes: Sequence[Tuple[int, int]],
                     strides: Sequence[int]) -> np.ndarray:
    """Static anchor lattice (sum H*W*A, 4) float32, as torchvision's
    AnchorGenerator: zero-centered cell anchors shifted by the stride grid."""
    all_anchors = []
    for (h, w), stride, size in zip(feature_shapes, strides, ANCHOR_SIZES):
        cell = []
        for ar in ASPECT_RATIOS:
            h_r = np.sqrt(ar)
            w_r = 1.0 / h_r
            ws, hs = w_r * size, h_r * size
            cell.append([-ws / 2, -hs / 2, ws / 2, hs / 2])
        cell = np.asarray(cell, np.float32)
        sx = np.arange(w, dtype=np.float32) * stride
        sy = np.arange(h, dtype=np.float32) * stride
        sx, sy = np.meshgrid(sx, sy)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                          axis=1)
        anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        all_anchors.append(anchors.astype(np.float32))
    return np.concatenate(all_anchors, axis=0)


class RPNHead(nn.Module):
    """torchvision names: `conv` (3x3, compute dtype), `cls_logits` and
    `bbox_pred` (1x1, float32)."""

    def __init__(self, in_channels: int = 256, num_anchors: int = NUM_ANCHORS,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        c = self.conv.in_channels
        init_lecun(self.conv, 9 * c, generator)
        init_lecun(self.cls_logits, c, generator)
        init_lecun(self.bbox_pred, c, generator)

    def forward(self, feats: List[torch.Tensor]):
        """feats: list of (B, H, W, C). Returns (objectness (B, sum HWA),
        deltas (B, sum HWA, 4)) concatenated over levels."""
        objs, regs = [], []
        for f in feats:
            t = F.relu(conv_nhwc(f, self.conv, self.dtype, 1)).to(torch.float32)
            B, H, W, _ = t.shape
            objs.append(conv_nhwc(t, self.cls_logits, torch.float32).reshape(
                B, H * W * self.num_anchors))
            regs.append(conv_nhwc(t, self.bbox_pred, torch.float32).reshape(
                B, H * W * self.num_anchors, 4))
        return torch.cat(objs, dim=1), torch.cat(regs, dim=1)


def match_anchors(anchors, gt_boxes, gt_valid, high: float = 0.7,
                  low: float = 0.3, allow_low_quality: bool = True):
    """anchors (N, 4); gt_boxes (B, G, 4) padded; gt_valid (B, G) bool.
    Returns (matched_gt_idx (B, N), labels (B, N)): 1 pos / 0 neg / -1
    ignore."""
    iou = box_iou(anchors, gt_boxes)                        # (B, N, G)
    neg1 = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
    iou = torch.where(gt_valid[:, None, :], iou, neg1)
    best = torch.amax(iou, dim=2)
    matched = torch.argmax(iou, dim=2)                      # first maximum
    one, zero = torch.ones_like(matched), torch.zeros_like(matched)
    labels = torch.where(best >= high, one, torch.where(best < low, zero,
                                                        -one))
    if allow_low_quality:
        best_per_gt = torch.amax(iou, dim=1)                # (B, G)
        is_best = ((iou == best_per_gt[:, None, :]) & gt_valid[:, None, :]
                   & (best_per_gt[:, None, :] > 0))
        labels = torch.where(torch.any(is_best, dim=2), one, labels)
    no_gt = ~torch.any(gt_valid, dim=1)
    labels = torch.where(no_gt[:, None], zero, labels)
    return matched, labels


def sample_balanced(rand: torch.Tensor, labels: torch.Tensor,
                    num_samples: int = 256, pos_fraction: float = 0.5):
    """torchvision BalancedPositiveNegativeSampler with injected uniform
    noise `rand` (B, n): the `n_pos` positives (up to num * frac) and
    `num - n_pos` negatives of highest noise. Stable argsorts, as
    `jnp.argsort`. Returns (pos_mask, neg_mask), (B, n) bool."""
    B, n = labels.shape
    num_pos_max = int(num_samples * pos_fraction)
    ar = torch.arange(n, device=labels.device).expand(B, n)
    neg1 = torch.full((), -1.0, dtype=rand.dtype, device=rand.device)

    def ranks_of(mask):
        order = torch.argsort(-torch.where(mask, rand, neg1), dim=1,
                              stable=True)
        return torch.empty_like(order).scatter_(1, order, ar)

    pos = labels == 1
    n_pos = torch.clamp(pos.sum(dim=1), max=num_pos_max)
    pos_mask = pos & (ranks_of(pos) < n_pos[:, None])
    neg = labels == 0
    n_neg = torch.minimum(neg.sum(dim=1), num_samples - n_pos)
    neg_mask = neg & (ranks_of(neg) < n_neg[:, None])
    return pos_mask, neg_mask


def sigmoid_bce(logits, targets):
    """Elementwise sigmoid binary cross-entropy (the JAX package's
    `optax_sigmoid_bce`)."""
    return -(targets * F.logsigmoid(logits) +
             (1.0 - targets) * F.logsigmoid(-logits))


def rpn_loss(rand, anchors, objectness, deltas, gt_boxes, gt_valid):
    """Per-image objectness and box losses, (B,) each. rand (B, N) is the
    sampler's noise; objectness (B, N), deltas (B, N, 4)."""
    matched, labels = match_anchors(anchors, gt_boxes, gt_valid)
    pos_mask, neg_mask = sample_balanced(rand, labels, 256, 0.5)
    sampled = pos_mask | neg_mask
    n_sampled = torch.clamp(sampled.sum(dim=1), min=1)

    matched_gt = torch.gather(gt_boxes, 1,
                              matched[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(matched_gt, anchors)
    box_l = smooth_l1(deltas, reg_targets, beta=1.0 / 9.0).sum(-1)
    zero = torch.zeros((), dtype=box_l.dtype, device=box_l.device)
    box_loss = torch.where(pos_mask, box_l, zero).sum(dim=1) / n_sampled

    bce = sigmoid_bce(objectness, labels.to(torch.float32))
    obj_loss = torch.where(sampled, bce, zero).sum(dim=1) / n_sampled
    return obj_loss, box_loss


def select_proposals(objectness, deltas, anchors, level_slices,
                     image_size: int, pre_nms_top_n: int, post_nms_top_n: int,
                     nms_thresh: float = 0.7, min_size: float = 1e-3,
                     return_index: bool = False, anchor_valid=None,
                     content_wh=None):
    """Per image: per-level top-k -> decode -> clip -> level-aware NMS ->
    post_nms_top_n proposals and their validity: ((B, P, 4), (B, P)).
    level_slices: list of (start, end) into the anchors. The per-level top-k
    is a stable descending sort, as `jax.lax.top_k` breaks ties by index.
    With `return_index`, also the (B, P) indices into the concatenated
    per-level candidates.

    anchor_valid: optional (N,) bool, the anchors inside the batch-max
    content extent (torchvision pads a batch to its largest image, so the
    others do not exist there); the rest get -inf objectness before the
    top-k. content_wh: optional (B, 2) (w, h): each image's proposals are
    clipped to its own pre-pad extent, as torchvision's `filter_proposals`
    does, instead of to the canvas."""
    if anchor_valid is not None:
        objectness = torch.where(anchor_valid, objectness,
                                 torch.full((), float("-inf"),
                                            dtype=objectness.dtype,
                                            device=objectness.device))
    sel_scores, sel_boxes, sel_levels = [], [], []
    for li, (s, e) in enumerate(level_slices):
        k = min(pre_nms_top_n, e - s)
        sc, idx = torch.sort(objectness[:, s:e], dim=1, descending=True,
                             stable=True)
        sc, idx = sc[:, :k], idx[:, :k]
        d = torch.gather(deltas[:, s:e], 1, idx[..., None].expand(-1, -1, 4))
        sel_scores.append(sc)
        sel_boxes.append(decode_boxes(d, anchors[s:e][idx]))
        sel_levels.append(torch.full((k,), li, dtype=torch.int32,
                                     device=objectness.device))
    scores = torch.cat(sel_scores, dim=1)
    boxes = clip_to_canvas(torch.cat(sel_boxes, dim=1), image_size,
                           content_wh)
    levels = torch.cat(sel_levels)
    valid = small_box_mask(boxes, min_size) & (scores > float("-inf"))
    idx, ok = batched_nms_topk(boxes, torch.sigmoid(scores), levels,
                               nms_thresh, post_nms_top_n, valid)
    out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return (out, ok, idx) if return_index else (out, ok)
