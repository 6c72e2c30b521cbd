"""RoI heads (port of `ssl4gie_tpu/models/roi_heads.py`).

torchvision `RoIHeads` semantics with static shapes: proposal sampling (512
per image, 0.25 positive fraction, IoU 0.5/0.5 without low-quality matches,
GT boxes appended to the proposals), MultiScaleRoIAlign 7x7, TwoMLPHead
(`box_head.fc6`, `fc7`, 1024 wide) and FastRCNNPredictor
(`box_predictor.cls_score`, `bbox_pred`, box weights (10, 10, 5, 5)),
cross-entropy and smooth-L1 losses, and the static-shape inference
postprocess. Batched over images where the JAX package vmaps.

`assign_proposals` takes its sampling noise and its tie-break noise as
tensors, so the tests can feed it the JAX package's draws. fc6 reads the
RoI features flattened in (y, x, c) order, as the JAX package's NHWC layout
gives them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.layers import init_lecun
from ssl4gie_tpu_torch.models.rpn import sample_balanced
from ssl4gie_tpu_torch.ops.boxes import (box_iou, clip_to_canvas,
                                         decode_boxes, encode_boxes,
                                         small_box_mask, smooth_l1)
from ssl4gie_tpu_torch.ops.nms import batched_nms_topk
from ssl4gie_tpu_torch.ops.roi_align import multiscale_roi_align
from ssl4gie_tpu_torch.parallel.distributed import batch_divisor

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int = 1024, num_classes: int = 2):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 4)


class BoxHead(nn.Module):
    """TwoMLPHead (`box_head`, compute dtype) + FastRCNNPredictor
    (`box_predictor`, float32)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 2,
                 representation_size: int = 1024, pool: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.box_head = TwoMLPHead(in_channels * pool * pool,
                                   representation_size)
        self.box_predictor = FastRCNNPredictor(representation_size,
                                               num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.box_head.fc6, self.box_head.fc7,
                    self.box_predictor.cls_score, self.box_predictor.bbox_pred):
            init_lecun(lin, lin.in_features, generator)

    def forward(self, roi_feats):
        """roi_feats: (R, 7, 7, C) -> (scores (R, K), deltas (R, K, 4))."""
        R, dt = roi_feats.shape[0], self.dtype
        x = roi_feats.reshape(R, -1).to(dt)
        for fc in (self.box_head.fc6, self.box_head.fc7):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        x = x.to(torch.float32)
        scores = self.box_predictor.cls_score(x)
        deltas = self.box_predictor.bbox_pred(x)
        return scores, deltas.reshape(R, self.num_classes, 4)


def assign_proposals(sample_rand, tie_rand, proposals, prop_valid, gt_boxes,
                     gt_labels, gt_valid, batch_size_per_image: int = 512,
                     positive_fraction: float = 0.25, fg_iou: float = 0.5):
    """Per image: append the GT boxes to the proposals, match at 0.5 (no
    low-quality matches), sample. sample_rand and tie_rand: (B, P + G)
    uniform noise. Returns (sampled boxes (B, S, 4), class labels (B, S),
    regression targets (B, S, 4), positive mask (B, S), sampled-valid
    (B, S)), S = batch_size_per_image."""
    proposals = torch.cat([proposals, gt_boxes], dim=1)
    prop_valid = torch.cat([prop_valid, gt_valid], dim=1)

    iou = box_iou(proposals, gt_boxes)                      # (B, P+G, G)
    iou = torch.where(gt_valid[:, None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=iou.device))
    matched = torch.argmax(iou, dim=2)
    best = torch.amax(iou, dim=2)
    one, zero = torch.ones_like(matched), torch.zeros_like(matched)
    labels = torch.where(best >= fg_iou, one, zero)
    labels = torch.where(prop_valid, labels, -one)
    no_gt = ~torch.any(gt_valid, dim=1)
    labels = torch.where(no_gt[:, None] & prop_valid, zero, labels)

    pos_mask, neg_mask = sample_balanced(sample_rand, labels,
                                         batch_size_per_image,
                                         positive_fraction)
    sampled_mask = pos_mask | neg_mask
    S = batch_size_per_image
    score = sampled_mask.to(torch.float32) * 2.0 + pos_mask.to(torch.float32)
    # the tie noise is continuous, so the top-S has no ties to break
    _, idx = torch.topk(score + tie_rand * 0.5, S, dim=1)
    take = lambda t: torch.gather(t, 1, idx)
    take4 = lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, 4))
    sampled_valid = take(sampled_mask)
    pos_s = take(pos_mask)
    boxes_s = take4(proposals)
    matched_s = take(matched)
    cls_labels = torch.where(pos_s, torch.gather(gt_labels.long(), 1,
                                                 matched_s), 0)
    reg_targets = encode_boxes(
        torch.gather(gt_boxes, 1, matched_s[..., None].expand(-1, -1, 4)),
        boxes_s, BOX_REG_WEIGHTS)
    return boxes_s, cls_labels, reg_targets, pos_s, sampled_valid


def roi_head_loss(scores, deltas, labels, reg_targets, pos_mask, valid):
    """torchvision fastrcnn_loss: CE over the sampled, smooth-L1 over the
    positives with the matched class's deltas, both over the number
    sampled (the global batch's when it is split over ranks,
    `distributed.batch_divisor`). Inputs flattened over images: scores (R,
    K), deltas (R, K, 4)."""
    n_sampled = batch_divisor(valid.sum(), floor=1)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    logp = F.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    cls_loss = torch.where(valid, ce, zero).sum() / n_sampled
    d = torch.gather(deltas, 1, labels[:, None, None].expand(-1, 1, 4))[:, 0]
    bl = smooth_l1(d, reg_targets, beta=1.0 / 9.0).sum(-1)
    box_loss = torch.where(pos_mask & valid, bl, zero).sum() / n_sampled
    return cls_loss, box_loss


def postprocess_detections(scores, deltas, proposals, prop_valid,
                           image_size: int, score_thresh: float = 0.05,
                           nms_thresh: float = 0.5,
                           detections_per_img: int = 100, content_wh=None):
    """scores (B, R, K) logits; deltas (B, R, K, 4); proposals (B, R, 4).
    Returns dict(boxes (B, D, 4), scores (B, D), labels (B, D), valid
    (B, D)). content_wh: optional (B, 2) (w, h) pre-pad extents: each
    image's boxes are clipped to its own before the NMS, as torchvision's
    `RoIHeads` clips to `image_shapes` (clipping moves IoUs, so it must come
    before the NMS)."""
    B, R, K = scores.shape
    probs = torch.softmax(scores, dim=-1)
    boxes_k = decode_boxes(deltas, proposals[:, :, None, :].expand(-1, -1, K,
                                                                   -1),
                           BOX_REG_WEIGHTS)
    boxes_k = clip_to_canvas(boxes_k, image_size, content_wh)
    probs, boxes_k = probs[..., 1:], boxes_k[:, :, 1:]      # drop background
    flat_boxes = boxes_k.reshape(B, R * (K - 1), 4)
    flat_scores = probs.reshape(B, R * (K - 1))
    flat_labels = torch.arange(1, K, dtype=torch.int32,
                               device=scores.device).repeat(R)
    valid = ((flat_scores > score_thresh) & small_box_mask(flat_boxes, 1e-2)
             & prop_valid.repeat_interleave(K - 1, dim=1))
    idx, ok = batched_nms_topk(flat_boxes, flat_scores, flat_labels,
                               nms_thresh, detections_per_img, valid)
    return {"boxes": torch.gather(flat_boxes, 1,
                                  idx[..., None].expand(-1, -1, 4)),
            "scores": torch.gather(flat_scores, 1, idx),
            "labels": flat_labels[idx],
            "valid": ok}


def extract_roi_features(feature_maps: List[torch.Tensor], boxes,
                         strides=(4, 8, 16, 32), extent_hw=None):
    """FPN levels 0..3 feed RoIAlign (the pool level is excluded, as
    torchvision's featmap_names ['0', '1', '2', '3']). feature_maps: list of
    (B, H, W, C); boxes (B, R, 4) -> (B, R, 7, 7, C)."""
    return multiscale_roi_align(feature_maps[:4], boxes,
                                [1.0 / s for s in strides],
                                extent_hw=extent_hw)
