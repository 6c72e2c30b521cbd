"""Held-out evaluation with the reference's post-processing and ledger
output (port of `ssl4gie_tpu/tasks/evaluate.py`).

- classification (`eval_classification.py:41-61`): argmax predictions over
  the test split, then mF1, mPrecision, mRecall and accuracy;
- segmentation (`eval_segmentation.py:25-70`): one image at a time, the
  ground truth at its native size, the 224 px logits resized to it
  bilinearly as `jax.image.resize` does (antialiased when shrinking,
  `ops/resize.py:resize_bilinear`), then Dice, IoU, precision and recall
  averaged over the images, and the optional per-instance list;
- depth (`eval_depth.py:31-61`): the 224 px prediction scale- and
  shift-aligned to the 224 px ground truth, resized to max(h, w) and
  center-cropped to the native size (torchvision's `center_crop`, Python's
  `round`), clamped to [0, 1], zero where the ground truth is invalid,
  scaled by 10, then RMSE, median relative error and absolute error per
  image, averaged.

The model runs in eval mode on its own device; each function prints its
results and appends them to `<results_root>/eval_results.txt`.
"""

from __future__ import annotations

import numpy as np
import torch

from ssl4gie_tpu_torch.core.config import TrainConfig
from ssl4gie_tpu_torch.core.logger import append_eval_results
from ssl4gie_tpu_torch.data.augment import eval_batch
from ssl4gie_tpu_torch.data.loader import Loader, prefetch_to_device
from ssl4gie_tpu_torch.metrics import classification as cls_metrics
from ssl4gie_tpu_torch.metrics import segmentation as seg_metrics
from ssl4gie_tpu_torch.metrics.depth import compute_scale_and_shift
from ssl4gie_tpu_torch.ops.resize import resize_bilinear


def _print_list_header(cfg: TrainConfig) -> str:
    """The per-instance list's variable name (`eval_segmentation.py:71-91`)."""
    arch_id = "RN_" if cfg.architecture.value == "resnet50" else "VT_"
    p = cfg.pretraining.value
    if p in ("Hyperkvasir", "ImageNet_self"):
        data_id = "HK_" if p == "Hyperkvasir" else "IN_"
        alg_id = {"mocov3": "MC_", "barlowtwins": "BT_",
                  "mae": "MA_"}[cfg.ss_framework.value]
        return arch_id + data_id + alg_id + cfg.data.dataset
    if p == "ImageNet_class":
        return arch_id + "IN_SL_" + cfg.data.dataset
    return arch_id + "NA_NA_" + cfg.data.dataset


def _forward_fn(model: torch.nn.Module):
    model.eval()
    device = next(model.parameters()).device

    @torch.no_grad()
    def fwd(img_u8: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the host -> the model's float32 output."""
        return model(eval_batch(torch.from_numpy(img_u8).to(device))).float()

    return fwd, device


def _report(cfg, what: str, results: dict, results_root: str,
            per_instance=None) -> dict:
    header = f"{what} results for {cfg.run_name()}"
    lines = [f"{k}: {v}" for k, v in results.items()]
    for ln in [header] + lines:
        print(ln)
    append_eval_results(results_root, header, lines)
    if per_instance is not None:
        print(_print_list_header(cfg) + " = [")
        for r in per_instance:
            print(f"    {r},")
        print("]")
    return results


def evaluate_classification(cfg, model, test_source, n_class: int,
                            results_root: str = "."):
    model.eval()
    device = next(model.parameters()).device
    preds, targets = [], []
    loader = Loader(test_source, cfg.data.batch_size, shuffle=False,
                    drop_last=False)
    with torch.no_grad():
        for batch in prefetch_to_device(loader.epoch(0), device):
            preds.append(torch.argmax(model(eval_batch(batch["image"])),
                                      dim=-1))
            targets.append(batch["label"])
    preds, targets = torch.cat(preds), torch.cat(targets)
    results = {
        "mF1": float(cls_metrics.mean_f1(preds, targets, n_class)),
        "mPrecision": float(cls_metrics.mean_precision(preds, targets,
                                                       n_class)),
        "mRecall": float(cls_metrics.mean_recall(preds, targets, n_class)),
        "Accuracy": float(cls_metrics.accuracy(preds, targets)),
    }
    return _report(cfg, "Classification", results, results_root)


def evaluate_segmentation(cfg, model, test_source, results_root: str = ".",
                          print_list: bool = False):
    """test_source yields native-size masks
    (`SegmentationSource(native_target=True)`), one image at a time as the
    reference's batch-1 eval loader."""
    fwd, device = _forward_fn(model)
    acc = {"Dice": 0.0, "IoU": 0.0, "Precision": 0.0, "Recall": 0.0}
    per_instance = []
    n = len(test_source)
    for i in range(n):
        s = test_source.get(i)
        mask = torch.from_numpy(s["mask"][None]).to(device)  # (1, h, w, 1)
        logits = resize_bilinear(fwd(s["image"][None]), mask.shape[1],
                                 mask.shape[2])
        d = float(seg_metrics.dice_score(logits, mask))
        acc["Dice"] += d
        acc["IoU"] += float(seg_metrics.iou_score(logits, mask))
        acc["Precision"] += float(seg_metrics.precision_score(logits, mask))
        acc["Recall"] += float(seg_metrics.recall_score(logits, mask))
        per_instance.append(d)
    results = {k: v / n for k, v in acc.items()}
    return _report(cfg, "Segmentation", results, results_root,
                   per_instance if print_list else None)


def _center_crop(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """torchvision's center_crop on an (H, W) array. `round` is Python's,
    which rounds halves to even, as torchvision's does."""
    H, W = arr.shape
    top = int(round((H - h) / 2.0))
    left = int(round((W - w) / 2.0))
    return arr[top:top + h, left:left + w]


def evaluate_depth(cfg, model, test_source, results_root: str = ".",
                   print_list: bool = False, metric_scale: float = 10.0):
    """test_source: `DepthSource(with_native=True)`."""
    fwd, device = _forward_fn(model)
    acc = {"RMSE": 0.0, "Relative Error": 0.0, "Absolute Error": 0.0}
    per_instance = []
    n = len(test_source)
    for i in range(n):
        s = test_source.get(i)
        out = fwd(s["image"][None])[0, :, :, 0]                # (224, 224)
        target224 = torch.from_numpy(s["depth"][:, :, 0]).to(device)
        native = s["native_depth"][:, :, 0]
        h, w = native.shape
        # scale/shift-align on the 224 px pair (`eval_depth.py:43-44`)
        sc, sh = compute_scale_and_shift(out[None], target224[None],
                                         (target224 > 0)[None].float())
        out = sc[0] * out + sh[0]
        # resize to the max(h, w) square, center-crop to (h, w)
        # (`eval_depth.py:46-51`)
        m = max(h, w)
        out = resize_bilinear(out[None, :, :, None], m, m)[0, :, :, 0]
        out = _center_crop(out.cpu().numpy(), h, w)
        out = np.clip(out, 0.0, 1.0)
        out[native == 0.0] = 0.0
        pred = out * metric_scale
        gt = native * metric_scale
        valid = gt > 0
        rmse = float(np.sqrt(np.mean((pred - gt)[valid] ** 2)))
        with np.errstate(divide="ignore", invalid="ignore"):   # gt == 0
            rel = float(np.median(np.abs((pred - gt) / gt)[valid]))
        abse = float(np.mean(np.abs(pred - gt)[valid]))
        acc["RMSE"] += rmse
        acc["Relative Error"] += rel
        acc["Absolute Error"] += abse
        per_instance.append(rmse)
    results = {k: v / n for k, v in acc.items()}
    return _report(cfg, "Depth estimation", results, results_root,
                   per_instance if print_list else None)
