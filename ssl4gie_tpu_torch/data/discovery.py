"""Filesystem dataset discovery (port of `ssl4gie_tpu/data/discovery.py`),
matching each reference build():

- Hyperkvasir-labelled classification: the 3-level folder walk under
  labeled-images/, filtered to anatomical-landmarks/ or
  pathological-findings/, class ids in sorted folder order,
  inverse-frequency class weights (`train_classification.py:130-157`);
- Kvasir-SEG / CVC-ClinicDB segmentation globs
  (`train_segmentation.py:127-136`);
- Kvasir-SEG detection: images/* and bounding-boxes.json
  (`train_detection.py:171-177`);
- C3VD depth: video folders with the fixed test {t2v2, c4v3} and val
  {t4v1, c2v3} splits and *color.png / *depth.tiff listings
  (`train_depth.py:119-152`).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import List, Tuple


@dataclasses.dataclass
class ClassificationData:
    input_paths: List[str]
    targets: List[int]
    n_class: int
    class_weights: List[float]


def discover_classification(root: str, dataset: str) -> ClassificationData:
    if dataset.endswith("pathological"):
        class_type = "pathological-findings/"
    elif dataset.endswith("anatomical"):
        class_type = "anatomical-landmarks/"
    else:
        raise ValueError(f"unknown classification dataset {dataset}")
    sub_folders: List[str] = []
    for bf in sorted(glob.glob(root + "/labeled-images/*/")):
        sub_folders += sorted(glob.glob(bf + "*/"))
    class_folders: List[str] = []
    for sf in sub_folders:
        if sf.endswith(class_type):
            class_folders += sorted(glob.glob(sf + "*/"))
    input_paths, targets, n_in_class = [], [], []
    for class_id, folder in enumerate(class_folders):
        contents = sorted(glob.glob(folder + "*.jpg"))
        input_paths += contents
        targets += [class_id] * len(contents)
        n_in_class.append(len(contents))
    n_class = len(class_folders)
    n_total = len(input_paths)
    class_weights = [1 / n * n_total / n_class for n in n_in_class]
    return ClassificationData(input_paths, targets, n_class, class_weights)


def discover_segmentation(root: str, dataset: str
                          ) -> Tuple[List[str], List[str]]:
    if dataset == "Kvasir":
        return (sorted(glob.glob(root + "/images/*")),
                sorted(glob.glob(root + "/masks/*")))
    if dataset == "CVC":
        return (sorted(glob.glob(root + "/Original/*")),
                sorted(glob.glob(root + "/Ground Truth/*")))
    raise ValueError(f"unknown segmentation dataset {dataset}")


def discover_detection(root: str, dataset: str = "Kvasir"):
    """(sorted image paths, the parsed bounding-boxes.json)."""
    input_paths = sorted(glob.glob(root + "/images/*"))
    with open(os.path.join(root, "bounding-boxes.json")) as f:
        targets = json.load(f)
    return input_paths, targets


_FRAME_RE = re.compile(r"(\d+)")


def _frame_sorted(paths: List[str]) -> List[str]:
    """Frame-number-aware sort (the reference's `eval_depth.py:113-129`
    sorts eval frames numerically, since 10 < 2 lexically)."""
    def keyfn(p):
        m = _FRAME_RE.findall(os.path.basename(p))
        return (int(m[0]) if m else 0, p)
    return sorted(paths, key=keyfn)


def discover_depth(root: str, numeric_sort: bool = False):
    """dict(split -> (rgb_paths, depth_paths)) for C3VD."""
    sub_folders: List[str] = []
    for bf in sorted(glob.glob(root + "/*/")):
        sub_folders += sorted(glob.glob(bf + "*/"))
    test_vids = [root + "/trans_t2_b_under_review/t2v2/",
                 root + "/cecum_t4_b_under_review/c4v3/"]
    val_vids = [root + "/trans_t4_a_under_review/t4v1/",
                root + "/cecum_t2_c_under_review/c2v3/"]
    train_vids = [v for v in sub_folders if v not in test_vids + val_vids]
    order = _frame_sorted if numeric_sort else sorted

    def listing(vids):
        rgb, depth = [], []
        for vid in vids:
            rgb += order(glob.glob(vid + "*color.png"))
            depth += order(glob.glob(vid + "*depth.tiff"))
        return rgb, depth

    return {"train": listing(train_vids), "val": listing(val_vids),
            "test": listing(test_vids)}
