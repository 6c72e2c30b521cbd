"""The NMS kernel's share of its roofline, in %: the least time of a
step's greedy NMS (`nms_work.py`: k x N IoUs an image at the float32 rate
outside the tensor cores, boxes, scores and outputs read or written once,
for every image of the step) over the card time a step of the kernel
(`nms_ms`). No such kernel in the slice, or a run of a configuration
whose NMS shape `config_of` does not know: nothing."""

import json

from portbench import nms_work
from portbench.configs import vitdet_det1024 as program
from portbench.metrics import nms_ms


def config_of(rec: dict):
    """`vitdet_det1024`, the configuration whose RPN runs this NMS, when
    `rec` is a run of it: the record names no configuration, so its FLOPs
    an image and its attention must be that configuration's. Otherwise
    None, and the shape of another configuration's NMS is not guessed."""
    with open(nms_work.CONFIG) as f:
        cfg = json.load(f)
    if (rec.get("flops_per_image") != program.flops_per_image(cfg)
            or rec.get("attention") != program.attention(cfg, rec["batch"])):
        return None
    return cfg


def read(rec: dict):
    s = nms_ms.seconds(rec)
    cfg = config_of(rec)
    if s is None or cfg is None:
        return None
    return 100.0 * nms_work.rpn_step_bound(rec["batch"], cfg) / s
