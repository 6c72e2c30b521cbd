"""Prediction renderers (port of `ssl4gie_tpu/tasks/predict.py`, the
reference's predict_*.py):

- segmentation (`predict_segmentation.py:20-38`): the thresholded mask at
  the image's native resolution;
- depth (`predict_depth.py:17-63`): the scale- and shift-aligned depth in
  magma and its absolute error in bone;
- detection (`predict_detection.py:29-76`): the ground-truth boxes (yellow)
  and the predictions above 0.5 (green) drawn on the original image.

Each predictor is two parts: `render_*` runs the model (in eval mode,
without autograd, on the model's device) and returns the uint8 arrays, and
`predict_*` writes them as PNGs (PIL, imported there) into `out_dir`.
Classification has no predictor, in the reference either.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from ssl4gie_tpu_torch.metrics.depth import compute_scale_and_shift
from ssl4gie_tpu_torch.ops.resize import resize_bilinear
from ssl4gie_tpu_torch.tasks.colormaps import COLORMAPS
from ssl4gie_tpu_torch.tasks.detection import (boxes_to_original,
                                               clip_to_content,
                                               make_detection_eval_step)
from ssl4gie_tpu_torch.tasks.evaluate import _forward_fn

GT_COLOR, PRED_COLOR = (255, 255, 0), (0, 255, 0)


def _colormap(x: np.ndarray, name: str = "magma") -> np.ndarray:
    """x in [0, 1] -> uint8 RGB by the 256-entry table `name`, indexed as
    matplotlib indexes a float array: floor(x * 256) in x's dtype, 1.0 on
    the last entry, NaN black."""
    xa = np.clip(np.asarray(x), 0, 1) * 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[bad] = 0
    out = COLORMAPS[name][idx]
    out[bad] = 0
    return out


def _indices(test_source, indices: Optional[Iterable[int]]):
    return list(indices) if indices is not None else range(len(test_source))


def _write_png(path: str, array: np.ndarray) -> str:
    from PIL import Image
    Image.fromarray(array).save(path)
    return path


def render_segmentation(model, sample: dict) -> np.ndarray:
    """The predicted mask of one sample at its mask's (native) size, uint8
    0/255 (h, w): the logits resized as `jax.image.resize` bilinear, then
    sigmoid > 0.5."""
    fwd, _ = _forward_fn(model)
    logits = fwd(sample["image"][None])
    h, w = sample["mask"].shape[:2]
    logits = resize_bilinear(logits, h, w)
    mask = (torch.sigmoid(logits) > 0.5)[0, :, :, 0].cpu().numpy()
    return (mask * 255).astype(np.uint8)


def render_depth(model, sample: dict) -> tuple[np.ndarray, np.ndarray]:
    """(magma depth, bone error), each (H, W, 3) uint8 at the model's
    size: the prediction aligned to the 224 px ground truth by its closed
    form scale and shift, clipped to [0, 1]; the error 0 where the ground
    truth is."""
    fwd, _ = _forward_fn(model)
    out = fwd(sample["image"][None])[0, :, :, 0].cpu().numpy()
    t224 = sample["depth"][:, :, 0]
    sc, sh = compute_scale_and_shift(torch.from_numpy(out[None]),
                                     torch.from_numpy(t224[None]),
                                     torch.from_numpy((t224 > 0)[None]))
    aligned = np.clip(float(sc[0]) * out + float(sh[0]), 0, 1)
    err = np.abs(aligned - t224)
    err[t224 == 0] = 0.0
    return _colormap(aligned, "magma"), _colormap(err, "bone")


def draw_boxes(img_u8: np.ndarray, boxes, color,
               thickness: int = 2) -> np.ndarray:
    """Rectangle outlines on an (H, W, 3) uint8 array (cv2.rectangle's)."""
    out = img_u8.copy()
    H, W = out.shape[:2]
    for b in boxes:
        x0, y0, x1, y1 = [int(round(float(v))) for v in b]
        x0, x1 = max(x0, 0), min(x1, W - 1)
        y0, y1 = max(y0, 0), min(y1, H - 1)
        for t in range(thickness):
            if y0 + t < H:
                out[y0 + t, x0:x1 + 1] = color
            if 0 <= y1 - t < H:
                out[y1 - t, x0:x1 + 1] = color
            if x0 + t < W:
                out[y0:y1 + 1, x0 + t] = color
            if 0 <= x1 - t < W:
                out[y0:y1 + 1, x1 - t] = color
    return out


def detect(model, sample: dict) -> tuple[np.ndarray, np.ndarray]:
    """Every detection of one sample, as its render makes them: boxes (K,
    4) on the canvas and their scores (K,), in the model's order. A
    sample's content size makes the model emulate torchvision's padding (a
    batch of one is its own batch-max) and clips its boxes."""
    device = next(model.parameters()).device
    img = torch.from_numpy(sample["image"][None]).to(device).to(
        torch.float32) / 255.0
    cs = (torch.from_numpy(sample["content_size"][None]).to(device)
          if "content_size" in sample else None)
    det = {k: v[0].cpu().numpy()
           for k, v in make_detection_eval_step(model)(img, cs).items()}
    boxes = det["boxes"][det["valid"]]
    if "content_size" in sample:
        boxes = clip_to_content(boxes, sample["content_size"])
    return boxes, det["scores"][det["valid"]]


def draw_detections(sample: dict, pred: np.ndarray) -> np.ndarray:
    """The sample's ground truth and the boxes `pred` (on the canvas)
    drawn on its original image (the boxes mapped back through the
    placement), or on the canvas when the sample has no original
    (synthetic)."""
    gt = sample["gt_boxes"][sample["gt_valid"]]
    if "original" in sample:
        canvas = sample["original"]
        gt = boxes_to_original(gt, sample["pad"], sample["scale"])
        pred = boxes_to_original(pred, sample["pad"], sample["scale"])
    else:
        canvas = sample["image"]
    return draw_boxes(draw_boxes(canvas, gt, GT_COLOR), pred, PRED_COLOR)


def render_detection(model, sample: dict,
                     score_thresh: float = 0.5) -> np.ndarray:
    """One sample's ground truth and detections above `score_thresh`
    drawn on its original image, or on the canvas (synthetic)."""
    boxes, scores = detect(model, sample)
    return draw_detections(sample, boxes[scores > score_thresh])


def predict_segmentation(cfg, model, test_source, out_dir: str,
                         indices: Optional[Iterable[int]] = None):
    """`pred_<i>.png` for each test index; returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    return [_write_png(os.path.join(out_dir, f"pred_{i}.png"),
                       render_segmentation(model, test_source.get(i)))
            for i in _indices(test_source, indices)]


def predict_depth(cfg, model, test_source, out_dir: str,
                  indices: Optional[Iterable[int]] = None):
    """`depth_<i>.png` and `error_<i>.png` for each test index."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in _indices(test_source, indices):
        depth, err = render_depth(model, test_source.get(i))
        written += [_write_png(os.path.join(out_dir, f"depth_{i}.png"), depth),
                    _write_png(os.path.join(out_dir, f"error_{i}.png"), err)]
    return written


def predict_detection(cfg, model, test_source, out_dir: str,
                      indices: Optional[Iterable[int]] = None,
                      score_thresh: float = 0.5):
    """`det_<i>.png` for each test index, on the original images where the
    source keeps them (`keep_original`, set here)."""
    os.makedirs(out_dir, exist_ok=True)
    if hasattr(test_source, "keep_original"):
        test_source.keep_original = True
    return [_write_png(os.path.join(out_dir, f"det_{i}.png"),
                       render_detection(model, test_source.get(i),
                                        score_thresh))
            for i in _indices(test_source, indices)]
