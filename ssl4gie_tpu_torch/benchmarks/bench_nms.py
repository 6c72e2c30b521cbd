"""Times the NMS kernel (`csrc/nms.cu`, `kernels/nms.py`) on the card at its
path shapes: the RPN's train call (16 images of 8,768 candidates, k 1,000
at IoU 0.7: the ViT-B detector's microbatch of 16 at 1024 px) and the
detections' eval call (2 images of 1,000, k 100 at 0.5). The candidates
are RPN-like: boxes of sides 8-512 px around uniform centres, clipped to
the canvas and kept apart by level as `batched_nms_topk` shifts them,
scores the sigmoid of N(0, 1). Before it is timed, the kernel's output is
held against the slot loop (`ops/nms.py:_nms_topk`) on the same card, bit
for bit.

Each shape is timed per call through the wrapper (median of 20 CUDA-event
readings), back to back (20 calls between two events) and, as the plain
version, the slot loop on the card (median of 3). The bound is the larger
of the k x N IoUs an image at 12 float32 operations over 67 TFLOP/s and
each candidate's 21 bytes and each slot's 9 at 3.35 TB/s. Prints one JSON
line with the card's name and power limit:

    python3 -m ssl4gie_tpu_torch.benchmarks.bench_nms
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import nms as nms_kernel
from ssl4gie_tpu_torch.ops import nms as ops_nms

SHAPES = {"nms_rpn_train": (16, 2000 * 4 + 16 * 16 * 3, 1000, 0.7),
          "nms_eval": (2, 1000, 100, 0.5)}
CANVAS, LEVELS = 1024.0, 5
FLOPS_PER_IOU, PEAK_FP32, PEAK_BYTES = 12, 67e12, 3.35e12
RUNS, B2B_RUNS, LOOP_RUNS = 20, 20, 3


def candidates(B: int, N: int, gen: torch.Generator):
    dev = gen.device
    c = CANVAS * torch.rand((B, N, 2), generator=gen, device=dev)
    side = 8.0 * 64.0 ** torch.rand((B, N, 2), generator=gen, device=dev)
    boxes = torch.cat([c - side / 2, c + side / 2], -1).clamp(0.0, CANVAS)
    level = torch.randint(0, LEVELS, (B, N), generator=gen, device=dev)
    boxes = boxes + level[..., None].float() * (CANVAS + 1.0)
    scores = torch.sigmoid(torch.randn((B, N), generator=gen, device=dev))
    valid = (boxes[..., 2] - boxes[..., 0] >= 1e-3) & \
        (boxes[..., 3] - boxes[..., 1] >= 1e-3)
    return boxes, scores, valid


def event_ms(fn, runs: int, per: int = 1) -> list:
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    return out


def work(B: int, N: int, k: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: k x N IoUs an image; each candidate's
    box, score and validity read once, each slot's index and validity
    written once."""
    return FLOPS_PER_IOU * B * k * N, B * (N * (16 + 4 + 1) + k * (8 + 1))


def bound_ms(B: int, N: int, k: int) -> float:
    flops, nbytes = work(B, N, k)
    return 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def card() -> dict:
    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        out["power_limit_w"] = None
    return out


def phase() -> dict:
    """Each shape's times and its bitwise check against the slot loop."""
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (B, N, k, thr) in SHAPES.items():
        boxes, scores, valid = candidates(B, N, gen)
        call = lambda: nms_kernel.nms_topk(boxes, scores, thr, k, valid)
        before = nms_kernel.nms_topk.launches
        got = ops_nms.nms_topk(boxes, scores, thr, k, valid)
        launches = nms_kernel.nms_topk.launches - before
        want = ops_nms._nms_topk(boxes, scores, thr, k, valid)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: the kernel and the slot loop "
                                 "disagree")
        for _ in range(3):
            call()
        loop = lambda: ops_nms._nms_topk(boxes, scores, thr, k, valid)
        rows[name] = {
            "shape": [B, N], "k": k, "launches_per_call": launches,
            "kept_per_image": float(got[1].sum(1).float().mean()),
            "kernel_ms": statistics.median(event_ms(call, RUNS)),
            "b2b_ms": statistics.median(event_ms(call, 1, B2B_RUNS)),
            "slot_loop_ms": statistics.median(event_ms(loop, LOOP_RUNS)),
            "bound_ms": bound_ms(B, N, k)}
    return rows


def main() -> None:
    print(json.dumps({"card": card(), **phase()}), flush=True)


if __name__ == "__main__":
    main()
