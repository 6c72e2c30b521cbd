"""The NMS kernel's card time a step, in ms: the seconds of the operations
named `nms_greedy_slots` (`csrc/nms.cu`) in the CUDA-only profiler slice,
over its steps. No such kernel in the slice (an NMS run as the eager slot
loop, many small kernels): nothing."""

import re

PATTERN = re.compile(r"nms_greedy_slots")


def seconds(rec: dict):
    """The kernel's card seconds a step, or None."""
    dev = rec["device"]
    if dev is None:
        return None
    s = sum(v for name, v in dev["op_seconds"].items()
            if PATTERN.search(name)) / dev["steps"]
    return s if s > 0 else None


def read(rec: dict):
    s = seconds(rec)
    return None if s is None else 1e3 * s
