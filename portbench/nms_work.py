"""The NMS kernel's yardstick: the work of greedy NMS and its least time.

Pure Python, frozen with the benchmark. The work is what the slot loop
needs: k slots an image, each the IoU of the chosen box with every one of
the image's N candidates, so k x N IoUs an image; each IoU is 12 float32
operations (four max or min for the overlap's corners, two subtractions
and two clamps for its sides, a product, the union's add and subtract, and
the divide), at the card's float32 rate outside the tensor cores. The
bytes: each candidate's box (16), score (4) and validity (1) read once, each
slot's index (8) and validity (1) written once.
"""

from __future__ import annotations

import json
from pathlib import Path

from portbench import work

FLOPS_PER_IOU = 12
# NVIDIA H100 SXM data sheet, float32 outside the tensor cores, at 700 W
PEAK_FP32_FLOPS = 67e12
CANDIDATE_BYTES = 16 + 4 + 1
SLOT_BYTES = 8 + 1
CONFIG = Path(__file__).resolve().parent / "configs" / "vitdet_det1024.json"


def nms_work(images: int, n: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of greedy NMS keeping k of n candidates in each of
    `images` images."""
    return (float(FLOPS_PER_IOU * images * k * n),
            float(images * (n * CANDIDATE_BYTES + k * SLOT_BYTES)))


def bound_seconds(images: int, n: int, k: int) -> float:
    flops, nbytes = nms_work(images, n, k)
    return work.bound_seconds(flops, nbytes, PEAK_FP32_FLOPS)


def rpn_candidates(cfg: dict) -> int:
    """The RPN's candidates an image: per level the anchors of highest
    objectness, up to `rpn_pre_nms_top_n_train`."""
    s, top = cfg["img_size"], cfg["rpn_pre_nms_top_n_train"]
    cells = [(s // st) ** 2 for st in cfg["fpn_strides"][:4]]
    cells.append(((s // 32 + 1) // 2) ** 2)
    return sum(min(top, c * len(cfg["aspect_ratios"])) for c in cells)


def rpn_step_bound(images: int, cfg: dict) -> float:
    """The least time of a training step's NMS over `images` images: the
    RPN's, once an image."""
    return bound_seconds(images, rpn_candidates(cfg),
                         cfg["rpn_post_nms_top_n_train"])
