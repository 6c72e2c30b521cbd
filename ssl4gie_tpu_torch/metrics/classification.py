"""Classification loss and metrics (port of `ssl4gie_tpu/metrics/classification.py`).

meanF1/meanPrecision/meanRecall are per-class one-vs-rest with smooth=1e-8,
averaged over classes, on the full prediction vector. The train loss is
cross-entropy with optional per-class weights, computed in float32; the MAE
finetune recipe's is the soft-target cross-entropy over label-smoothed (and
mixed) targets, and its evaluation reports accuracy@k.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.parallel.distributed import batch_divisor

SMOOTH = 1e-8


def weighted_cross_entropy(logits, labels, class_weights=None):
    """torch F.cross_entropy(weight=w) semantics in float32: per-sample NLL
    scaled by w[label], summed and divided by the sum of those weights over
    the global batch (`distributed.batch_divisor`) when it is split over
    ranks."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if class_weights is None:
        return torch.mean(nll)
    w = class_weights[labels.long()]
    return torch.sum(w * nll) / batch_divisor(torch.sum(w))


def _per_class(preds, targets, n_class: int):
    preds = preds.reshape(-1)
    targets = targets.reshape(-1)
    cls = torch.arange(n_class, device=preds.device)
    m1 = preds[None, :] == cls[:, None]
    m2 = targets[None, :] == cls[:, None]
    inter = torch.sum(m1 & m2, dim=1).to(torch.float32)
    s1 = torch.sum(m1, dim=1).to(torch.float32)
    s2 = torch.sum(m2, dim=1).to(torch.float32)
    return inter, s1, s2


def mean_f1(preds, targets, n_class: int, smooth: float = SMOOTH):
    inter, s1, s2 = _per_class(preds, targets, n_class)
    return torch.mean(2.0 * (inter + smooth) / (s1 + s2 + smooth))


def mean_precision(preds, targets, n_class: int, smooth: float = SMOOTH):
    inter, s1, _ = _per_class(preds, targets, n_class)
    return torch.mean((inter + smooth) / (s1 + smooth))


def mean_recall(preds, targets, n_class: int, smooth: float = SMOOTH):
    inter, _, s2 = _per_class(preds, targets, n_class)
    return torch.mean((inter + smooth) / (s2 + smooth))


def accuracy(preds, targets):
    return torch.mean((preds.reshape(-1) == targets.reshape(-1)).to(torch.float32))


def smooth_one_hot(labels, n_class: int, smoothing: float = 0.0):
    """Label-smoothed one-hot targets (B, n_class), float32: `smoothing /
    n_class` off the label, `1 - smoothing + smoothing / n_class` on it
    (timm's Mixup target transform, `Models/mae/main_finetune.py:219-226`)."""
    off = smoothing / n_class
    on = 1.0 - smoothing + off
    out = torch.full((labels.shape[0], n_class), off, dtype=torch.float32,
                     device=labels.device)
    return out.scatter_(1, labels.long()[:, None], on)


def soft_target_cross_entropy(logits, soft_targets):
    """timm SoftTargetCrossEntropy in float32: the batch mean of
    -sum(y * log_softmax(x)) (`main_finetune.py:251-254`)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.mean(torch.sum(-soft_targets * logp, dim=-1))


def accuracy_topk(logits, labels, ks=(1, 5)):
    """timm-style accuracy@k in percent, one float32 scalar per k
    (`engine_finetune.py:98-130`); k is capped at the class count."""
    n_class = logits.shape[-1]
    out = []
    for k in ks:
        top = torch.topk(logits, min(k, n_class), dim=-1).indices
        hit = torch.any(top == labels.long()[:, None], dim=1)
        out.append(100.0 * torch.mean(hit.to(torch.float32)))
    return tuple(out)
