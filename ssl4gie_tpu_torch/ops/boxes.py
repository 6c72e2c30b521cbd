"""Box utilities for the Faster R-CNN stack (port of `ssl4gie_tpu/ops/boxes.py`).

torchvision semantics: xyxy boxes, BoxCoder encode/decode with
per-coordinate weights and a log-space size clamp, IoU with widths
x2 - x1 (no +1). Every expression keeps the JAX package's order of float
operations, so equal inputs give equal outputs.
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., N, 4), b: (..., M, 4) -> (..., N, M); leading dims batch."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Deltas that map `proposals` (anchors) onto `reference` (GT), (..., 4)."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (reference[..., 0] + reference[..., 2]) * 0.5
    gy = (reference[..., 1] + reference[..., 3]) * 0.5
    gw = reference[..., 2] - reference[..., 0]
    gh = reference[..., 3] - reference[..., 1]
    pw = torch.clamp(pw, min=1e-6)
    ph = torch.clamp(ph, min=1e-6)
    dx = wx * (gx - px) / pw
    dy = wy * (gy - py) / ph
    dw = ww * torch.log(torch.clamp(gw, min=1e-6) / pw)
    dh = wh * torch.log(torch.clamp(gh, min=1e-6) / ph)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """deltas (..., 4) applied to anchors (..., 4) -> boxes xyxy."""
    wx, wy, ww, wh = weights
    px = (anchors[..., 0] + anchors[..., 2]) * 0.5
    py = (anchors[..., 1] + anchors[..., 3]) * 0.5
    pw = anchors[..., 2] - anchors[..., 0]
    ph = anchors[..., 3] - anchors[..., 1]
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy boxes to [0, width] x [0, height]; `height` and `width`
    are numbers or tensors that broadcast against `boxes[..., 0]` (one
    extent per image)."""
    def clip(v, hi):
        if torch.is_tensor(hi):
            return torch.minimum(torch.clamp(v, min=0.0), hi)
        return torch.clamp(v, 0.0, hi)

    return torch.stack([clip(boxes[..., 0], width),
                        clip(boxes[..., 1], height),
                        clip(boxes[..., 2], width),
                        clip(boxes[..., 3], height)], dim=-1)


def clip_to_canvas(boxes: torch.Tensor, image_size: int,
                   content_wh: torch.Tensor | None = None) -> torch.Tensor:
    """Clip (B, ..., 4) boxes to the square canvas, or, given content_wh
    (B, 2) integer (w, h) extents, each image's boxes to its own extent."""
    if content_wh is None:
        return clip_boxes(boxes, image_size, image_size)
    wh = content_wh.to(boxes.dtype).reshape(
        boxes.shape[0], *([1] * (boxes.ndim - 2)), 2)
    return clip_boxes(boxes, wh[..., 1], wh[..., 0])


def small_box_mask(boxes: torch.Tensor, min_size: float = 1e-3) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
