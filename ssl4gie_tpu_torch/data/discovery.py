"""Filesystem dataset discovery (port of `ssl4gie_tpu/data/discovery.py`),
for now Kvasir-SEG detection only: images/* and bounding-boxes.json
(`train_detection.py:171-177`)."""

from __future__ import annotations

import glob
import json
import os


def discover_detection(root: str, dataset: str = "Kvasir"):
    """(sorted image paths, the parsed bounding-boxes.json)."""
    input_paths = sorted(glob.glob(root + "/images/*"))
    with open(os.path.join(root, "bounding-boxes.json")) as f:
        targets = json.load(f)
    return input_paths, targets
