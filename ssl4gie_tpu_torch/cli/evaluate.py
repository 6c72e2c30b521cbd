"""Evaluation CLI (port of `ssl4gie_tpu/cli/evaluate.py`, the reference's
eval_*.py).

Loads the best-val checkpoint `<ckpt_dir>/<run_name>.pt` that cli.train
wrote onto the device and evaluates the held-out test split with the
native-resolution post-processing; appends to eval_results.txt:
  python -m ssl4gie_tpu_torch.cli.evaluate --task classification \\
      --synthetic --device cpu --compute-dtype float32
Detection prints the COCO mAP, mAP@50 and mAP@75 of the test split.
"""

from __future__ import annotations

import argparse

import torch

from ssl4gie_tpu_torch.cli.args import add_common, to_train_config
from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
from ssl4gie_tpu_torch.core.config import Task, compute_dtype
from ssl4gie_tpu_torch.core.logger import append_eval_results
from ssl4gie_tpu_torch.data import discovery
from ssl4gie_tpu_torch.data.loader import (ClassificationSource, DepthSource,
                                           SegmentationSource,
                                           SyntheticSource)
from ssl4gie_tpu_torch.data.splits import split_ids
from ssl4gie_tpu_torch.models.factory import build_model
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.tasks import evaluate as E
from ssl4gie_tpu_torch.tasks.build import SYNTHETIC_DET_TEST, detection_canvas
from ssl4gie_tpu_torch.tasks.detection import (DetectionSource,
                                               SyntheticDetectionSource,
                                               evaluate_map)


def _eval_model(cfg, extras: dict, device, **widths):
    """The task's model for evaluation on `device`: detection on the run's
    canvas, with the reduced test-time proposal counts under --synthetic
    (JAX `cli/evaluate.py:36-50`)."""
    dtype = compute_dtype(cfg.runtime)
    det = cfg.task == Task.DETECTION
    if det and cfg.data.synthetic:
        widths = {**SYNTHETIC_DET_TEST, **widths}
    return build_model(cfg.task, cfg.architecture,
                       num_classes=extras.get("n_class", 1),
                       pretraining=cfg.pretraining,
                       framework=cfg.ss_framework, out_token=cfg.out_token,
                       img_size=(detection_canvas(cfg)[0] if det
                                 else cfg.data.img_size),
                       dtype=dtype, device=device, **widths)


def load_eval_state(cfg, **widths):
    """(model with the run's best-val weights on `cfg.runtime.device`,
    extras). `widths` narrow the model, as `build_trainer`'s."""
    cfg.validate()
    extras = {}
    if cfg.task == Task.CLASSIFICATION:
        if cfg.data.synthetic:
            extras = {"n_class": 6}
        else:
            data = discovery.discover_classification(cfg.data.data_root,
                                                     cfg.data.dataset)
            extras = {"n_class": data.n_class}
    ckpt = ckpt_lib.CheckpointManager(cfg.ckpt_dir, cfg.run_name())
    if not ckpt.exists():
        raise FileNotFoundError(f"no checkpoint at {ckpt.path}: train first")
    device = default_device(cfg.runtime.device)
    model = _eval_model(cfg, extras, device, **widths)
    model.load_state_dict(ckpt.restore(map_location=device)["model"])
    return model, extras


def make_test_source(cfg):
    """The held-out test split's source (JAX `cli/evaluate.py:53-96`)."""
    if cfg.task == Task.DETECTION:
        canvas, resize = detection_canvas(cfg)
        if cfg.data.synthetic:
            return SyntheticDetectionSource(cfg.data.synthetic_size, canvas,
                                            seed=2)
        paths, targets = discovery.discover_detection(cfg.data.data_root,
                                                      cfg.data.dataset)
        _, te, _ = split_ids(len(paths))
        return DetectionSource([paths[i] for i in te], targets, canvas,
                               resize=resize)
    if cfg.data.synthetic:
        return SyntheticSource(cfg.data.synthetic_size, cfg.data.img_size,
                               cfg.task.value, seed=2,
                               with_native=cfg.task == Task.DEPTH)
    if cfg.task == Task.CLASSIFICATION:
        d = discovery.discover_classification(cfg.data.data_root,
                                              cfg.data.dataset)
        _, te, _ = split_ids(len(d.input_paths))
        return ClassificationSource([d.input_paths[i] for i in te],
                                    [d.targets[i] for i in te],
                                    cfg.data.img_size)
    if cfg.task == Task.SEGMENTATION:
        imgs, masks = discovery.discover_segmentation(cfg.data.data_root,
                                                      cfg.data.dataset)
        _, te, _ = split_ids(len(imgs))
        return SegmentationSource([imgs[i] for i in te],
                                  [masks[i] for i in te], cfg.data.img_size,
                                  native_target=True)
    splits = discovery.discover_depth(cfg.data.data_root, numeric_sort=True)
    rgb, dep = splits["test"]
    return DepthSource(rgb, dep, cfg.data.img_size, with_native=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_common(p)
    p.add_argument("--ckpt-dir", type=str, default="Trained models",
                   dest="ckpt_dir")
    p.add_argument("--print-list", action="store_true", dest="print_list")
    p.add_argument("--results-root", type=str, default=".",
                   dest="results_root")
    args = p.parse_args(argv)
    args.epochs = 1
    cfg = to_train_config(args)

    model, extras = load_eval_state(cfg)
    src = make_test_source(cfg)
    if cfg.task == Task.CLASSIFICATION:
        return E.evaluate_classification(cfg, model, src, extras["n_class"],
                                         args.results_root)
    if cfg.task == Task.SEGMENTATION:
        return E.evaluate_segmentation(cfg, model, src, args.results_root,
                                       args.print_list)
    if cfg.task == Task.DEPTH:
        return E.evaluate_depth(cfg, model, src, args.results_root,
                                args.print_list)
    return evaluate_detection(cfg, model, src, args.results_root)


def evaluate_detection(cfg, model, test_source, results_root: str = "."):
    """COCO mAP over the test split at the JAX CLI's eval batch of 2,
    printed and appended to eval_results.txt as the reference's
    `eval_detection.py:38-40`. Returns the mAP dict."""
    res = evaluate_map(model, test_source,
                       device=next(model.parameters()).device)
    header = f"Detection results for {cfg.run_name()}"
    lines = [f"mAP: {res['map']}", f"mAP@50: {res['map_50']}",
             f"mAP@75: {res['map_75']}"]
    for ln in [header] + lines:
        print(ln)
    append_eval_results(results_root, header, lines)
    return res


if __name__ == "__main__":
    main()
