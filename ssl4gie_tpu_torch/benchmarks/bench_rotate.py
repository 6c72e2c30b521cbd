"""Times the rotation kernel (#3, `csrc/rotate.cu`) on the card at its path
shapes: (64, 224, 224, 3), the ViT classification step's batch, (48, 352,
352, 5), the segmentation affine's canvas (the ViT and RN50 seg steps),
and (48, 224, 224, 3), the RN50 classification step's batch. Random
angles plus the angles where the rot90 fold changes quarter turn; before
it is timed, the kernel's output is held against its plain version element
for element.

Each shape is timed per call through the wrapper (median of 20 CUDA-event
readings) and back to back (100 launches of the C entry point between two
events: the wrapper's checks and allocation take about as long as the
kernel at 224 px). Both cycle over enough input/output pairs (at least
200 MB) that a launch does not find its data in the card's 50 MB L2 cache,
as the path's augmentation, which writes other tensors in between, does not
either. Prints one JSON line with the card's name and power limit.

It imports only the rotation's modules, and the C entry point
`ssl4gie_shear_rotate` has the same signature as in the one-thread-per-
element kernel the tiled one replaced, so two checkouts can be compared in
one call on one card:

    PYTHONPATH=<checkout> python3 <this file>

times the kernel of the `ssl4gie_tpu_torch` under <checkout>.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess

import torch

import ssl4gie_tpu_torch
from ssl4gie_tpu_torch.data.augment import rotation_factors
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import rotate as rot

SHAPES = {"shear_rotate": (64, 224, 224, 3),
          "shear_rotate_seg": (48, 352, 352, 5),
          "shear_rotate_rn50_cls": (48, 224, 224, 3)}
# the angles where the fold changes quarter turn, and whole quarter turns
BOUNDARY = (0.0, 90.0, 180.0, -90.0, 45.0, -45.0, 135.0, -135.0)
CYCLE_BYTES = 200e6       # > 4x the H100's 50 MB L2
RUNS, B2B_RUNS = 20, 100


def rotation_case(shape, gen: torch.Generator):
    """Input/output pairs on the card for `shape`, bf16 pixels in [0, 1],
    enough of them that their bytes reach CYCLE_BYTES, and one set of
    per-image (quarter, alpha, beta) from random and boundary angles."""
    nb = shape[0]
    dev = gen.device
    pair_bytes = 2 * math.prod(shape) * 2
    n_pairs = max(2, math.ceil(CYCLE_BYTES / pair_bytes))
    gs = [(torch.randint(0, 256, shape, generator=gen, device=dev)
           .to(torch.bfloat16) / 255.0).contiguous() for _ in range(n_pairs)]
    angle = torch.rand((nb,), generator=gen, device=dev) * 360.0 - 180.0
    angle[:len(BOUNDARY)] = torch.tensor(BOUNDARY, device=dev)
    return gs, rotation_factors(angle)


def check_exact(gs, factors, fill: float = 0.0) -> None:
    """The wrapper's output is the plain version's, element for element."""
    q, alpha, beta = factors
    for i, g in enumerate(gs):
        got = rot.shear_rotate(g, alpha, beta, fill, quarter=q)
        ref = rot.shear_rotate_plain(g, alpha, beta, fill, quarter=q)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"rotation {tuple(g.shape)} pair {i}: "
                f"{int((got != ref).sum())} elements differ from the plain "
                "version (must be element-exact)")


def cycled(gs, factors, fill: float = 0.0):
    """(per call, back to back) closures that rotate the next pair at each
    call: the first through the wrapper, the second by the C entry point."""
    q, alpha, beta = factors
    outs = [torch.empty_like(g) for g in gs]
    nb, h, w, c = gs[0].shape
    state = {"i": 0}

    def nxt():
        i = state["i"] = (state["i"] + 1) % len(gs)
        return i

    def per_call():
        return rot.shear_rotate(gs[nxt()], alpha, beta, fill, quarter=q)

    def entry():
        i = nxt()
        _build.launch("ssl4gie_shear_rotate", gs[i].data_ptr(),
                      alpha.data_ptr(), beta.data_ptr(), q.data_ptr(),
                      outs[i].data_ptr(), nb, h, w, c, fill,
                      torch.cuda.current_stream().cuda_stream)
    return per_call, entry


def per_call_ms(fn, runs: int = RUNS) -> float:
    """Median over `runs` of one call between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, runs: int = B2B_RUNS) -> float:
    """Time per call of `runs` calls issued between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_rotate: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, shape in SHAPES.items():
        gs, factors = rotation_case(shape, gen)
        check_exact(gs, factors)
        per_call, entry = cycled(gs, factors)
        rows[name] = {"shape": list(shape), "pairs": len(gs),
                      "ms": per_call_ms(per_call),
                      "b2b_ms": back_to_back_ms(entry)}
        del gs
    print(json.dumps({"package": ssl4gie_tpu_torch.__file__, "card": card,
                      "rotation": rows}))


if __name__ == "__main__":
    main()
