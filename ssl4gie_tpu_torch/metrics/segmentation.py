"""Binary-segmentation loss and metrics (port of
`ssl4gie_tpu/metrics/segmentation.py`).

The soft Dice loss on sigmoid probabilities, and Dice, IoU, precision and
recall on 0.5-thresholded masks, each per image with smooth = 1e-8, then
the batch mean; all in float32.
"""

from __future__ import annotations

import torch

SMOOTH = 1e-8


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def soft_dice_loss(logits, targets, smooth: float = SMOOTH):
    m1 = _flatten(torch.sigmoid(logits.to(torch.float32)))
    m2 = _flatten(targets.to(torch.float32))
    inter = torch.sum(m1 * m2, dim=1)
    score = 2.0 * (inter + smooth) / (torch.sum(m1 * m1, dim=1)
                                      + torch.sum(m2 * m2, dim=1) + smooth)
    return 1.0 - torch.mean(score)


def _thresholded(logits, targets, apply_sigmoid: bool):
    probs = logits.to(torch.float32)
    if apply_sigmoid:
        probs = torch.sigmoid(probs)
    m1 = _flatten(probs) > 0.5
    m2 = _flatten(targets.to(torch.float32)) > 0.5
    inter = torch.sum((m1 & m2).to(torch.float32), dim=1)
    return inter, torch.sum(m1.to(torch.float32), dim=1), \
        torch.sum(m2.to(torch.float32), dim=1)


def dice_per_image(logits, targets, apply_sigmoid: bool = True,
                   smooth: float = SMOOTH):
    """Per-image Dice, shape (B,)."""
    inter, s1, s2 = _thresholded(logits, targets, apply_sigmoid)
    return 2.0 * (inter + smooth) / (s1 + s2 + smooth)


def dice_score(logits, targets, apply_sigmoid: bool = True,
               smooth: float = SMOOTH):
    return torch.mean(dice_per_image(logits, targets, apply_sigmoid, smooth))


def dice_pair(logits, targets):
    """(numerator, denominator) per image for padded-batch evaluation: the
    per-image Dice and ones."""
    d = dice_per_image(logits, targets)
    return d, torch.ones_like(d)


def iou_score(logits, targets, apply_sigmoid: bool = True,
              smooth: float = SMOOTH):
    inter, s1, s2 = _thresholded(logits, targets, apply_sigmoid)
    return torch.mean((inter + smooth) / (s1 + s2 - inter + smooth))


def precision_score(logits, targets, apply_sigmoid: bool = True,
                    smooth: float = SMOOTH):
    inter, s1, _ = _thresholded(logits, targets, apply_sigmoid)
    return torch.mean((inter + smooth) / (s1 + smooth))


def recall_score(logits, targets, apply_sigmoid: bool = True,
                 smooth: float = SMOOTH):
    inter, _, s2 = _thresholded(logits, targets, apply_sigmoid)
    return torch.mean((inter + smooth) / (s2 + smooth))
