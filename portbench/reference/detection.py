"""Plain float32 pieces of a two-stage detector, torchvision's Faster R-CNN
as SSL4GIE runs it (`Object_detection/train_detection.py:243-250`), and the
seeded draws of the detection cell: the ground-truth boxes of the traffic,
the augmentation's factors, and the samplers' noise.

Imports nothing of the program. Boxes are xyxy float32 in canvas pixels.
Each function is one image's unless it says otherwise; expressions keep
the order of the program's float operations where a discrete decision
hangs on them (anchors, IoU thresholds, the NMS), so that the reference and
the program decide alike up to the rounding of their inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import augment, plain

# the sub-streams of a seed beside `inputs`' WEIGHTS, TRAFFIC and STEP
BOXES, MODEL_NOISE = 3, 4
MAX_GT = 16
STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
XFORM_CLIP = math.log(1000.0 / 16)
SMOOTH_BETA = 1.0 / 9.0


# ------------------------------------------------------------------ draws

def draw_gt(traffic: dict, seed: int, device) -> list:
    """Each pool batch's ground truth from `seed`: {"gt_boxes" (B, MAX_GT,
    4), "gt_labels" (B, MAX_GT) int64, "gt_valid" (B, MAX_GT) bool}. An
    image holds `boxes_per_image` [lo, hi] boxes (uniform), each of class 1
    with sides U[`box_side`] of the canvas and its corner uniform where the
    box fits; the padding rows are zero and invalid."""
    gen = inputs.generator(seed, BOXES, device)
    P, B, S = traffic["pool"], traffic["batch"], float(traffic["canvas"])
    lo, hi = traffic["boxes_per_image"]
    s_lo, s_hi = traffic["box_side"]
    count = torch.randint(lo, hi + 1, (P, B, 1), generator=gen, device=device)
    side = S * (s_lo + (s_hi - s_lo) * torch.rand(
        (P, B, MAX_GT, 2), generator=gen, device=device))
    corner = (S - side) * torch.rand((P, B, MAX_GT, 2), generator=gen,
                                     device=device)
    valid = torch.arange(MAX_GT, device=device) < count
    boxes = torch.cat([corner, corner + side], dim=-1)
    boxes = torch.where(valid[..., None], boxes, torch.zeros((), device=device))
    return [{"gt_boxes": boxes[i], "gt_labels": valid[i].long(),
             "gt_valid": valid[i]} for i in range(P)]


def draw_augment(B: int, gen: torch.Generator) -> dict:
    """The detection augmentation's factors, in the order the program draws
    them: brightness U[0.6, 1.4], contrast U[0.5, 1.5], saturation U[0.75,
    1.25], hue U[-0.01, 0.01], one order of the four jitter ops, blur sigma
    U[0.001, 2], then the quarter-turn, h-flip and v-flip flags (U[0, 1) >
    0.5 each)."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((B,), generator=gen,
                                                   device=gen.device)
    p = {name: u(1 - x, 1 + x) for name, x in (("brightness", 0.4),
                                              ("contrast", 0.5),
                                              ("saturation", 0.25))}
    p["hue"] = u(-0.01, 0.01)
    p["order"] = torch.randperm(4, generator=gen, device=gen.device).tolist()
    p["sigma"] = u(0.001, 2.0)
    for flag in ("rot", "hflip", "vflip"):
        p[flag] = torch.rand((B,), generator=gen, device=gen.device) > 0.5
    return p


def draw_noise(B: int, anchors: int, proposals: int,
               gen: torch.Generator) -> dict:
    """A microbatch's sampler noise U[0, 1): the RPN's (B, anchors), the RoI
    sampler's and the RoI tie-break's (B, proposals + MAX_GT) each, in that
    order."""
    r = lambda n: torch.rand((B, n), generator=gen, device=gen.device)
    return {"rpn": r(anchors), "roi_sample": r(proposals + MAX_GT),
            "roi_tie": r(proposals + MAX_GT)}


# ------------------------------------------------------------ augmentation

def augment_batch(img_u8: torch.Tensor, gt: torch.Tensor, p: dict,
                  rnd=None):
    """(B, S, S, 3) uint8 and (B, G, 4) boxes -> float32 images in [0, 1]
    and the moved boxes: colour jitter and the 25-tap blur
    (`reference/augment.py`), then a quarter-turn counter-clockwise, an
    h-flip and a v-flip where drawn, moving the boxes with the image
    (`Data/dataset.py:50-80`). `rnd` rounds each op's result (the
    control)."""
    exact = rnd is None
    rnd = rnd or (lambda x: x)
    dev = img_u8.device
    p = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in p.items()}
    B, S = img_u8.shape[:2]
    img = rnd(img_u8.to(torch.float32) / 255.0)
    img = augment.gaussian_blur(augment.color_jitter(img, p, rnd), p["sigma"],
                                rnd=None if exact else rnd)
    x0, y0, x1, y1 = gt.unbind(-1)
    flag = lambda k: p[k].reshape(B, 1, 1, 1)
    # counter-clockwise: pixel (y, x) comes from (x, S - 1 - y); a point
    # (x, y) goes to (y, S - x)
    img = torch.where(flag("rot"), img.transpose(1, 2).flip(1), img)
    r = p["rot"][:, None]
    x0, y0, x1, y1 = (torch.where(r, y0, x0), torch.where(r, S - x1, y0),
                      torch.where(r, y1, x1), torch.where(r, S - x0, y1))
    img = torch.where(flag("hflip"), img.flip(2), img)
    h = p["hflip"][:, None]
    x0, x1 = torch.where(h, S - x1, x0), torch.where(h, S - x0, x1)
    img = torch.where(flag("vflip"), img.flip(1), img)
    v = p["vflip"][:, None]
    y0, y1 = torch.where(v, S - y1, y0), torch.where(v, S - y0, y1)
    return img, torch.stack([x0, y0, x1, y1], dim=-1)


# ------------------------------------------------------------ layers

def conv(x: torch.Tensor, weight, bias, precision: str,
         padding: int = 0) -> torch.Tensor:
    """A stride-1 convolution of one (H, W, C) map as a product over each
    output position's receptive field in the weight's (c, kh, kw) order."""
    O, C, kh, kw = weight.shape
    H, W = x.shape[:2]
    if kh == kw == 1:
        cols = x
    else:
        cols = F.unfold(x.permute(2, 0, 1)[None], (kh, kw), padding=padding)
        cols = cols[0].t().reshape(H, W, C * kh * kw)
    return plain.linear(cols, weight.reshape(O, -1), bias, precision)


def deconv2x(x: torch.Tensor, weight, bias, precision: str) -> torch.Tensor:
    """A 2 x 2 stride-2 transposed convolution of one (H, W, C) map:
    out[2i + a, 2j + b] = x[i, j] . weight[:, :, a, b] + bias."""
    H, W, C = x.shape
    O = weight.shape[1]
    y = plain.matmul(x.reshape(H * W, C), weight.reshape(C, O * 4), precision)
    y = y.reshape(H, W, O, 2, 2).permute(0, 3, 1, 4, 2).reshape(2 * H, 2 * W,
                                                                O)
    return y + bias


def layer_norm(x, w: dict, name: str, eps: float = 1e-6):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], eps)


# ------------------------------------------------------------ boxes

def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a, b):
    """(N, 4), (M, 4) -> (N, M): inter / max(union, 1e-12) where union > 0,
    else 0, with union = (area_a + area_b) - inter."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros((), device=a.device))


def encode(gt, ref, weights=(1.0, 1.0, 1.0, 1.0)):
    """The deltas that move the boxes `ref` onto `gt`, (..., 4)."""
    wx, wy, ww, wh = weights
    pw = torch.clamp(ref[..., 2] - ref[..., 0], min=1e-6)
    ph = torch.clamp(ref[..., 3] - ref[..., 1], min=1e-6)
    px = (ref[..., 0] + ref[..., 2]) * 0.5
    py = (ref[..., 1] + ref[..., 3]) * 0.5
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-6)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-6)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)], -1)


def decode(deltas, ref):
    """The boxes that `deltas` (unit weights) make of `ref`, (..., 4)."""
    pw = ref[..., 2] - ref[..., 0]
    ph = ref[..., 3] - ref[..., 1]
    px = (ref[..., 0] + ref[..., 2]) * 0.5
    py = (ref[..., 1] + ref[..., 3]) * 0.5
    cx = deltas[..., 0] * pw + px
    cy = deltas[..., 1] * ph + py
    w = torch.exp(torch.clamp(deltas[..., 2], max=XFORM_CLIP)) * pw
    h = torch.exp(torch.clamp(deltas[..., 3], max=XFORM_CLIP)) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def smooth_l1(d):
    d = d.abs()
    return torch.where(d < SMOOTH_BETA, 0.5 * d * d / SMOOTH_BETA,
                       d - 0.5 * SMOOTH_BETA)


def level_shapes(canvas: int) -> list:
    """The (h, w) of the five levels: strides 4-32, then the stride-2
    subsample of the stride-32 level."""
    s32 = canvas // 32
    return [(canvas // s,) * 2 for s in STRIDES[:4]] + [((s32 + 1) // 2,) * 2]


def anchors(canvas: int, device) -> list:
    """Each level's anchors (h w 3, 4), row by row, three ratios a cell:
    the zero-centred cell anchors of sizes 32-512 (h = size sqrt(r), w =
    size / sqrt(r), in float64 then float32), shifted by the stride lattice
    in float32 (torchvision's AnchorGenerator without its rounding of the
    cell anchors)."""
    out = []
    for (h, w), stride, size in zip(level_shapes(canvas), STRIDES,
                                    ANCHOR_SIZES):
        cell = []
        for r in ASPECT_RATIOS:
            hr = np.sqrt(r)
            ws, hs = (1.0 / hr) * size, hr * size
            cell.append([-ws / 2, -hs / 2, ws / 2, hs / 2])
        cell = np.asarray(cell, np.float32)
        sx = np.arange(w, dtype=np.float32) * stride
        sy = np.arange(h, dtype=np.float32) * stride
        gx, gy = np.meshgrid(sx, sy)
        shift = np.stack([gx.ravel(), gy.ravel()] * 2, axis=1)
        out.append(torch.from_numpy(
            (shift[:, None, :] + cell[None]).reshape(-1, 4)).to(device))
    return out


# ------------------------------------------------------------ RPN

def top_candidates(objectness: list, deltas: list, anchors_: list,
                   canvas: int, pre_nms: int):
    """Per level the `pre_nms` anchors of highest objectness (a stable
    sort), their boxes decoded and clipped to the canvas: (boxes (n, 4),
    scores (n,) sigmoid, levels (n,), valid (n,): sides of 1e-3 or more)."""
    boxes, scores, levels = [], [], []
    for li, (o, d, a) in enumerate(zip(objectness, deltas, anchors_)):
        s, i = torch.sort(o, descending=True, stable=True)
        s, i = s[:pre_nms], i[:pre_nms]
        boxes.append(decode(d[i], a[i]).clamp(0.0, float(canvas)))
        scores.append(s)
        levels.append(torch.full_like(i, li))
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    valid = (w >= 1e-3) & (h >= 1e-3) & (scores > float("-inf"))
    return boxes, torch.sigmoid(scores), torch.cat(levels), valid


def greedy_nms(boxes, scores, groups, valid, thr: float, k: int):
    """Greedy NMS within each group: candidates in order of score, the
    highest first and among equal scores the lowest index; a candidate is
    kept unless a kept one of its group overlaps it by IoU > thr. The
    groups are kept apart as torchvision's `batched_nms` keeps them at few
    candidates, by shifting each group's boxes by its id times (the largest
    coordinate + 1). Returns (idx (k,), ok (k,)): the kept candidates in
    order, then index 0, not ok, for the slots past the last."""
    zero = torch.zeros((), device=boxes.device)
    top = torch.amax(torch.where(torch.isfinite(boxes), boxes, zero)) + 1.0
    shifted = boxes + groups.to(boxes.dtype)[:, None] * top
    live = torch.where(valid, scores, torch.full((), float("-inf"),
                                                 device=boxes.device))
    order = torch.argsort(-live, stable=True)
    over = box_iou(shifted[order], shifted[order]) > thr
    alive = torch.isfinite(live[order])
    idx, ok = [], []
    for _ in range(k):
        j = torch.argmax(alive.to(torch.uint8))     # the first alive
        took = alive[j]
        idx.append(torch.where(took, order[j], torch.zeros_like(order[j])))
        ok.append(took)
        alive = alive & ~(over[j] & took)
        alive[j] = False
    return torch.stack(idx), torch.stack(ok)


def match_anchors(anchors_, gt, gt_valid):
    """(matched gt (A,), labels (A,): 1 IoU >= 0.7, 0 below 0.3, -1
    between), each ground truth's best anchors (ties included) positive."""
    iou = torch.where(gt_valid[None, :], box_iou(anchors_, gt),
                      torch.full((), -1.0, device=gt.device))
    best = iou.max(dim=1).values
    matched = torch.argmax(iou, dim=1)                 # the first maximum
    labels = torch.where(best >= 0.7, 1, torch.where(best < 0.3, 0, -1))
    best_gt = iou.max(dim=0).values
    low_q = ((iou == best_gt[None]) & gt_valid[None] & (best_gt[None] > 0))
    labels = torch.where(low_q.any(dim=1), 1, labels)
    if not bool(gt_valid.any()):
        labels = torch.zeros_like(labels)
    return matched, labels


def sample(noise, labels, num: int, fraction: float):
    """The positives and negatives a sampler of `num` at `fraction`
    positive takes: those of highest noise (the lowest index among equal
    noise), up to num x fraction positives and the rest negatives.
    Returns (pos, neg) masks."""
    def highest(mask, n):
        order = torch.argsort(-torch.where(mask, noise, -1.0), stable=True)
        taken = torch.zeros_like(mask)
        taken[order[:n]] = True
        return taken & mask
    pos = labels == 1
    n_pos = min(int(pos.sum()), int(num * fraction))
    neg = labels == 0
    n_neg = min(int(neg.sum()), num - n_pos)
    return highest(pos, n_pos), highest(neg, n_neg)


def rpn_losses(noise, anchors_, objectness, deltas, gt, gt_valid):
    """One image's objectness (BCE) and box (smooth L1, beta 1/9) losses
    over 256 sampled anchors at half positive, each over the number
    sampled."""
    matched, labels = match_anchors(anchors_, gt, gt_valid)
    pos, neg = sample(noise, labels, 256, 0.5)
    taken = pos | neg
    n = max(int(taken.sum()), 1)
    target = encode(gt[matched], anchors_)
    box = smooth_l1(deltas - target).sum(-1)[pos].sum() / n
    bce = F.binary_cross_entropy_with_logits(
        objectness[taken], labels[taken].to(torch.float32), reduction="sum")
    return bce / n, box


# ------------------------------------------------------------ RoI heads

def roi_targets(noise, proposals, prop_valid, gt, gt_labels, gt_valid,
                num: int = 512, fraction: float = 0.25):
    """The ground truth appended to the proposals, matched at IoU 0.5 (no
    low-quality matches) and sampled: (boxes (S, 4), class (S,), box
    targets (S, 4), positive (S,)) of the S sampled."""
    boxes = torch.cat([proposals, gt])
    valid = torch.cat([prop_valid, gt_valid])
    iou = torch.where(gt_valid[None, :], box_iou(boxes, gt),
                      torch.full((), -1.0, device=gt.device))
    best = iou.max(dim=1).values
    matched = torch.argmax(iou, dim=1)
    labels = torch.where(best >= 0.5, 1, 0)
    if not bool(gt_valid.any()):
        labels = torch.zeros_like(labels)
    labels = torch.where(valid, labels, -1)
    pos, neg = sample(noise, labels, num, fraction)
    taken = pos | neg
    boxes, matched, pos = boxes[taken], matched[taken], pos[taken]
    cls = torch.where(pos, gt_labels[matched], 0)
    return boxes, cls, encode(gt[matched], boxes, BOX_WEIGHTS), pos


def roi_align(levels: list, rois, out: int = 7, ratio: int = 2):
    """torchvision's MultiScaleRoIAlign (aligned=False) over the maps of
    strides 4-32, (H, W, C) each: a RoI goes to level floor(4 +
    log2(sqrt(area) / 224 + 1e-6)) clamped to 2-5; out x out bins of ratio
    x ratio bilinear samples, a sample outside [-1, H] x [-1, W] 0, those
    inside clamped to the map, averaged. (R, 4) -> (R, out, out, C)."""
    area = torch.clamp(box_area(rois), min=0.0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-6))
    lvl = torch.clamp(lvl, 2, 5).long() - 2
    C = levels[0].shape[-1]
    result = torch.zeros((rois.shape[0], out, out, C), device=rois.device)
    grid = (torch.arange(out * ratio, dtype=torch.float32,
                         device=rois.device) + 0.5) / ratio
    for li, fmap in enumerate(levels):
        sel = (lvl == li).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        H, W = fmap.shape[:2]
        r = rois[sel] * (1.0 / STRIDES[li])
        rw = torch.clamp(r[:, 2] - r[:, 0], min=1.0)
        rh = torch.clamp(r[:, 3] - r[:, 1], min=1.0)
        ys = r[:, 1, None] + grid * (rh / out)[:, None]        # (n, P)
        xs = r[:, 0, None] + grid * (rw / out)[:, None]
        yy, xx = ys[:, :, None], xs[:, None, :]
        outside = (yy < -1.0) | (yy > H) | (xx < -1.0) | (xx > W)
        y = torch.clamp(yy, min=0.0).clamp(max=H - 1.0)
        x = torch.clamp(xx, min=0.0).clamp(max=W - 1.0)
        y0, x0 = torch.floor(y), torch.floor(x)
        y1, x1 = torch.clamp(y0 + 1, max=H - 1.0), torch.clamp(x0 + 1,
                                                               max=W - 1.0)
        wy, wx = y - y0, x - x0
        flat = fmap.reshape(H * W, C)
        tap = lambda yc, xc: flat[(yc * W + xc).long()]
        v = (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
             + tap(y0, x1) * ((1 - wy) * wx)[..., None]
             + tap(y1, x0) * (wy * (1 - wx))[..., None]
             + tap(y1, x1) * (wy * wx)[..., None])
        v = torch.where(outside[..., None], torch.zeros((), device=v.device),
                        v)
        n = sel.numel()
        result = result.index_put(
            (sel,), v.reshape(n, out, ratio, out, ratio, C).mean(dim=(2, 4)))
    return result


def roi_losses(scores, deltas, cls, targets, pos):
    """Sums over the sampled RoIs of the cross-entropy and of the positive
    ones' smooth L1 of their class's deltas (the caller divides by the
    microbatch's number sampled)."""
    ce = F.cross_entropy(scores, cls, reduction="sum")
    d = deltas[torch.arange(cls.shape[0], device=cls.device), cls]
    return ce, smooth_l1(d - targets).sum(-1)[pos].sum()
