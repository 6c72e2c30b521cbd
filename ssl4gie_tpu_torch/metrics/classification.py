"""Classification loss and metrics (port of `ssl4gie_tpu/metrics/classification.py`).

meanF1/meanPrecision/meanRecall are per-class one-vs-rest with smooth=1e-8,
averaged over classes, on the full prediction vector. The train loss is
cross-entropy with optional per-class weights, computed in float32.
"""

from __future__ import annotations

import torch

SMOOTH = 1e-8


def weighted_cross_entropy(logits, labels, class_weights=None):
    """torch F.cross_entropy(weight=w) semantics in float32: per-sample NLL
    scaled by w[label], summed and divided by the sum of those weights."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if class_weights is None:
        return torch.mean(nll)
    w = class_weights[labels.long()]
    return torch.sum(w * nll) / torch.sum(w)


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
