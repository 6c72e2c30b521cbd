"""The NMS kernel (`kernels/nms.py`, `csrc/nms.cu`) against the slot loop
that defines it (`ops/nms.py:_nms_topk`).

On the CPU: `ops.nms.nms_topk` routes CPU tensors to the loop, and the
kernel's algorithm (32-bit keys of the score's order, a slot's winner the
highest key and the lowest index among those that hold it, the IoU without
a branch, the stop at the first exhausted slot), emulated here, gives the
loop's output bit for bit. On the card
(marked `gpu`): the kernel itself at the RPN's train shape (16 images of
8,768 candidates, k 1,000) and the detections' eval shape (2 x 1,000, k
100) over 20 seeds each, with exact score ties, duplicate and degenerate
boxes, invalid candidates and exhausted slots, in one launch a call.

    python -m pytest tests/test_torch_nms.py -q
    python -m pytest --noconftest -m gpu tests/test_torch_nms.py -q   # card
"""

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.kernels import nms as nms_kernel
from ssl4gie_tpu_torch.ops import nms as ops_nms

NEG_INF_KEY = 0x007FFFFF
POS_INF_KEY = 0xFF800000


def candidates(B: int, N: int, seed: int, valid_share: float = 0.9,
               levels: int = 5, canvas: float = 1024.0):
    """RPN-like candidates: boxes of sides 2-400 px clipped to the canvas,
    kept apart by level as `batched_nms_topk` shifts them, a tenth exact
    copies of another box, some of zero width; scores on a grid of 64
    values, so that many tie exactly; `valid_share` of them valid."""
    g = torch.Generator().manual_seed(seed)
    c = canvas * torch.rand((B, N, 2), generator=g)
    wh = torch.exp(torch.empty((B, N, 2)).uniform_(np.log(2.0), np.log(400.0),
                                                   generator=g))
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1).clamp(0.0, canvas)
    dup = torch.rand((B, N), generator=g) < 0.1
    src = torch.randint(0, N, (B, N), generator=g)
    boxes = torch.where(dup[..., None],
                        torch.gather(boxes, 1, src[..., None].expand(-1, -1, 4)),
                        boxes)
    flat = torch.rand((B, N), generator=g) < 0.02
    boxes[..., 2] = torch.where(flat, boxes[..., 0], boxes[..., 2])
    level = torch.randint(0, levels, (B, N), generator=g)
    boxes = boxes + level[..., None].float() * (canvas + 1.0)
    scores = torch.randint(0, 64, (B, N), generator=g).float() / 64.0
    valid = torch.rand((B, N), generator=g) < valid_share
    return boxes, scores, valid


def order_key(s: np.float32) -> int:
    if np.isnan(s):
        return 0xFFFFFFFF
    u = int(np.array(s + np.float32(0.0), np.float32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def over(a, b, thr: np.float32) -> bool:
    """The kernel's `over`: iou(a, b) > thr in float32."""
    f = np.float32
    area = lambda x: f(f(x[2] - x[0]) * f(x[3] - x[1]))
    w = max(f(min(a[2], b[2]) - max(a[0], b[0])), f(0))
    h = max(f(min(a[3], b[3]) - max(a[1], b[1])), f(0))
    inter = f(w * h)
    uni = f(f(area(a) + area(b)) - inter)
    with np.errstate(all="ignore"):
        q = f(inter / max(uni, f(1e-12)))
    return bool((q if uni > 0 else f(0)) > thr)


def emulate(boxes, scores, thr: float, k: int, valid=None):
    """The kernel's loop on the host, image by image."""
    B, N = scores.shape
    bx = boxes.numpy().astype(np.float32)
    sc = scores.to(torch.float32).numpy()
    va = np.ones((B, N), bool) if valid is None else valid.numpy()
    thr = np.float32(thr)
    idx = np.zeros((B, k), np.int64)
    ok = np.zeros((B, k), bool)
    for b in range(B):
        key = [order_key(sc[b, c]) if va[b, c] else NEG_INF_KEY
               for c in range(N)]
        for slot in range(k):
            top = max(key)
            i = min(c for c in range(N) if key[c] == top)
            idx[b, slot], ok[b, slot] = i, NEG_INF_KEY < top < POS_INF_KEY
            if top <= NEG_INF_KEY:
                break                      # the rest stay index 0, invalid
            for c in range(N):
                if key[c] <= NEG_INF_KEY:
                    continue
                if c == i or (ok[b, slot] and over(bx[b, i], bx[b, c], thr)):
                    key[c] = NEG_INF_KEY
    return torch.from_numpy(idx), torch.from_numpy(ok)


@pytest.mark.parametrize("seed,N,k,valid_share", [
    (0, 120, 40, 0.9), (1, 120, 40, 0.9), (2, 64, 80, 0.9),   # exhausted
    (3, 150, 30, 0.05), (4, 1, 3, 1.0), (5, 97, 97, 0.5)])
def test_the_kernels_algorithm_is_the_slot_loop(seed, N, k, valid_share):
    boxes, scores, valid = candidates(2, N, seed, valid_share, levels=2,
                                      canvas=64.0)
    want = ops_nms._nms_topk(boxes, scores, 0.5, k, valid)
    got = emulate(boxes, scores, 0.5, k, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_algorithm_ranks_nan_and_inf_scores_as_argmax_does():
    boxes, scores, _ = candidates(1, 40, 7, canvas=32.0)
    scores[0, 3] = float("nan")
    scores[0, 9] = float("nan")
    scores[0, 5] = float("inf")
    scores[0, 11] = -0.0
    scores[0, 12] = 0.0
    want = ops_nms._nms_topk(boxes, scores, 0.3, 30, None)
    got = emulate(boxes, scores, 0.3, 30)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_tensors_take_the_slot_loop():
    boxes, scores, valid = candidates(2, 50, 11)
    before = nms_kernel.nms_topk.launches
    got = ops_nms.nms_topk(boxes, scores, 0.7, 20, valid)
    want = ops_nms._nms_topk(boxes, scores, 0.7, 20, valid)
    assert nms_kernel.nms_topk.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        nms_kernel.nms_topk(boxes, scores, 0.7, 20, valid)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = {"train": (16, 2000 * 4 + 768, 1000, 0.7),
          "eval": (2, 1000, 100, 0.5)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_slot_loop_on_card(card, shape):
    B, N, k, thr = SHAPES[shape]
    for seed in range(20):
        # every fourth seed leaves few candidates valid: slots run out
        boxes, scores, valid = candidates(B, N, seed,
                                          0.03 if seed % 4 == 3 else 0.9)
        boxes, scores, valid = boxes.to(card), scores.to(card), valid.to(card)
        before = nms_kernel.nms_topk.launches
        got = ops_nms.nms_topk(boxes, scores, thr, k, valid)
        assert nms_kernel.nms_topk.launches == before + 1
        want = ops_nms._nms_topk(boxes, scores, thr, k, valid)
        assert torch.equal(got[0], want[0]), (shape, seed)
        assert torch.equal(got[1], want[1]), (shape, seed)
        if seed % 4 == 3:
            assert not bool(got[1][:, -1].any())       # exhausted slots


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 31, 1025, 5000, 8192, 12000,
                               nms_kernel.MAX_CANDIDATES])
def test_kernel_sizes_and_specials_on_card(card, N):
    """Clusters of 1, 2, 5 and 8 blocks at one and two candidates a
    thread, a block's last threads without candidates, no valid mask, NaN,
    inf and -0 scores, and a second run bit for bit."""
    boxes, scores, _ = candidates(3, N, N)
    scores[:, ::7] = float("nan")
    scores[:, 1::11] = float("inf")
    scores[:, 2::13] = -0.0
    boxes, scores = boxes.to(card), scores.to(card)
    k = min(N + 5, 300)
    got = nms_kernel.nms_topk(boxes, scores, 0.6, k)
    want = ops_nms._nms_topk(boxes, scores, 0.6, k, None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = nms_kernel.nms_topk(boxes, scores, 0.6, k)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take_on_card(card):
    boxes, scores, _ = candidates(1, 10, 0)
    boxes, scores = boxes.to(card), scores.to(card)
    with pytest.raises(TypeError):
        nms_kernel.nms_topk(boxes.half(), scores, 0.5, 5)
    with pytest.raises(ValueError):
        nms_kernel.nms_topk(boxes[:, :0], scores[:, :0], 0.5, 5)
    big = torch.zeros((1, nms_kernel.MAX_CANDIDATES + 1, 4), device=card)
    with pytest.raises(ValueError):
        nms_kernel.nms_topk(big, big[..., 0], 0.5, 5)
