"""COCO-style mean average precision, host-side numpy (a copy of
`ssl4gie_tpu/metrics/detection.py`, which the port does not import).

Replaces `torchmetrics.detection.mean_ap.MeanAveragePrecision`, which the
reference uses to select and report detection (`train_detection.py:18,
136-151`): 101-point interpolated AP averaged over IoU thresholds
0.50:0.95:0.05 ("map"), plus map_50 and map_75, maxDets=100, greedy
best-IoU matching per the COCO protocol.

The greedy matching runs vectorized over all 10 IoU thresholds at once (one
numpy pass per prediction instead of a Python double loop per threshold).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).round(2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_all_thresholds(iou: np.ndarray, thrs: np.ndarray) -> np.ndarray:
    """Greedy COCO matching for score-sorted predictions, all thresholds at once.

    iou: (n_pred, n_gt) for predictions already sorted by descending score.
    Returns tp: (T, n_pred) bool. Each prediction matches the unmatched GT of
    highest IoU if that IoU >= the threshold (independently per threshold).
    The loop over predictions is inherent to greedy matching; everything inside
    it is vectorized over (thresholds x GTs).
    """
    T = len(thrs)
    n_pred, n_gt = iou.shape
    tp = np.zeros((T, n_pred), bool)
    if n_gt == 0 or n_pred == 0:
        return tp
    matched = np.zeros((T, n_gt), bool)
    rows = np.arange(T)
    for i in range(n_pred):
        cand = np.where(matched, -1.0, iou[i][None, :])      # (T, n_gt)
        # IoU ties go to the LAST gt (the scalar loop updated best on `>=`)
        j = n_gt - 1 - np.argmax(cand[:, ::-1], axis=1)      # (T,)
        ok = cand[rows, j] >= thrs
        tp[:, i] = ok
        matched[ok, j[ok]] = True
    return tp


def _ap_all_thresholds(scores: np.ndarray, tps: np.ndarray,
                       n_gt: int) -> np.ndarray:
    """scores (N,), tps (T, N) -> AP per threshold (T,). NaN row if no GT."""
    T = tps.shape[0]
    if n_gt == 0:
        return np.full((T,), np.nan)
    if scores.size == 0:
        return np.zeros((T,))
    # stable sort matches the reference python list.sort on (-score) ties
    order = np.argsort(-scores, kind="stable")
    tp = tps[:, order].astype(np.float32)
    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(1.0 - tp, axis=1)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # COCO: precision envelope, then 101-point interpolation
    precision = np.maximum.accumulate(precision[:, ::-1], axis=1)[:, ::-1]
    aps = np.empty((T,))
    n = precision.shape[1]
    for t in range(T):
        idx = np.searchsorted(recall[t], RECALL_POINTS, side="left")
        p_at_r = np.where(idx < n, precision[t][np.minimum(idx, n - 1)], 0.0)
        aps[t] = np.mean(p_at_r)
    return aps


class MeanAveragePrecision:
    """Accumulate per-image detections/targets; compute() -> dict like
    torchmetrics (map, map_50, map_75)."""

    def __init__(self, max_dets: int = 100):
        self.max_dets = max_dets
        self.preds: List[Dict] = []
        self.targets: List[Dict] = []

    def update(self, preds: List[Dict], targets: List[Dict]):
        """Each pred: dict(boxes (N,4), scores (N,), labels (N,)); each target:
        dict(boxes (M,4), labels (M,)). numpy arrays."""
        self.preds += [{k: np.asarray(v) for k, v in p.items()} for p in preds]
        self.targets += [{k: np.asarray(v) for k, v in t.items()} for t in targets]

    def compute(self) -> Dict[str, float]:
        classes = sorted({int(c) for t in self.targets
                          for c in np.unique(t["labels"])})
        T = len(IOU_THRESHOLDS)
        aps = np.full((T, len(classes)), np.nan)
        for ci, c in enumerate(classes):
            n_gt = 0
            scores_parts, tp_parts = [], []
            for p, t in zip(self.preds, self.targets):
                sel = p["labels"] == c
                boxes = p["boxes"][sel].reshape(-1, 4)
                scores = p["scores"][sel].reshape(-1)
                gt = t["boxes"][t["labels"] == c].reshape(-1, 4)
                n_gt += len(gt)
                order = np.argsort(-scores)[:self.max_dets]
                boxes, scores = boxes[order], scores[order]
                iou = _iou_matrix(boxes, gt)
                tp_parts.append(_match_all_thresholds(iou, IOU_THRESHOLDS))
                scores_parts.append(scores)
            aps[:, ci] = _ap_all_thresholds(
                np.concatenate(scores_parts) if scores_parts else np.zeros(0),
                np.concatenate(tp_parts, axis=1) if tp_parts
                else np.zeros((T, 0), bool), n_gt)
        with np.errstate(invalid="ignore"):
            return {"map": float(np.nanmean(aps)),
                    "map_50": float(np.nanmean(aps[0])),
                    "map_75": float(np.nanmean(aps[5]))}

    def reset(self):
        self.preds, self.targets = [], []
