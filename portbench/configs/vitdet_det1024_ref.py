"""The plain reference of `vitdet_det1024`: ViTDet-B Faster R-CNN (arXiv
2203.16527 as SSL4GIE builds it, `Models/models.py:155-259`,
`Object_detection/train_detection.py:243-250`) trained in float32 with
TF32 off, image by image.

A step: the detection augmentation of `reference/detection.py` (jitter, the
25-tap blur, a quarter-turn and flips moving the boxes); ImageNet
normalisation; the 16 x 16 patch projection, the 14 x 14 position table
resized bilinearly (align_corners) to the 64 x 64 grid; twelve pre-norm
blocks (exact GELU), 0, 1, 3, 4, 6, 7, 9 and 10 attending within 16 x 16
windows of the grid, 2, 5, 8 and 11 over all 4,096 tokens; the final
LayerNorm; the simple pyramid (a 2 x 2 max-pool, the map itself, one and
two 2 x 2 deconvolutions with LayerNorm and GELU between, each branch a
1 x 1 projection, LayerNorm, a 3 x 3 convolution and LayerNorm, and the
stride-2 subsample of the stride-32 level); the RPN's 3 x 3 convolution
and 1 x 1 heads over three anchors a cell at sizes 32-512; its matching
(0.7 / 0.3 with each ground truth's best anchors), 256 sampled at half
positive, BCE and smooth-L1 (beta 1/9) over the number sampled; the
proposals (per level the 2,000 of highest objectness, decoded, clipped,
sides of 1e-3 or more, a plain greedy NMS at 0.7 within each level, 1,000
kept); the RoI heads (the ground truth appended, matching at 0.5, 512
sampled at a quarter positive, RoIAlign 7 x 7 as a plain bilinear gather
of 2 x 2 samples a bin from the levels of strides 4-32, fc6 and fc7 of
1,024 with ReLU, the predictor, cross-entropy and smooth-L1 on box targets
weighted (10, 10, 5, 5) over the microbatch's number sampled); the loss of
a microbatch the mean of the images' RPN losses plus the RoI losses, the
step's gradient the mean of its microbatches'; AdamW (torch's) at the
configuration's rate.

The products run in float32 (`plain.matmul`; in the control, in fp8) where
the program computes in bfloat16 (the backbone, the pyramid, the RPN's 3 x
3 convolution, fc6 and fc7), and in float32 where it does (the RPN's 1 x 1
heads, the predictor, the losses). To fit the global attention, each image
is computed alone: a first pass without gradients finds its proposals and
the number its RoI sampler takes, so that the second, with gradients, can
divide by the microbatch's count.

It takes the program's draws from generators seeded as the program seeds
them, in the same order: the augmentation's factors from the host, the
samplers' noise from the device's generator, a microbatch at a time.

Imports nothing of the program. Departures from the published
description, all the program's own:
- static shapes: a fixed number of proposals with a validity mask, the
  ground truth padded to 16 boxes with a mask;
- the ground truth is appended to the proposals before the RoI sampling
  (torchvision does the same) and the levels are kept apart in the NMS by
  shifting each level's boxes (torchvision's coordinate trick, which it
  swaps for a per-level loop above 5,000 candidates, a different rounding
  of the same sets);
- the samplers take the candidates of highest injected noise in place of
  torch.randperm's draw;
- the cell anchors are not rounded to whole pixels;
- the pyramid's LayerNorms are over the channels (the configuration's
  `fpn_ln_mode`), not over (C, H, W);
- the GELU of the blocks is the exact one, where the program's bfloat16
  blocks take the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import augment, detection, plain


def _window_blocks(x, w, name, heads, precision, grid: int, win: int):
    """A block whose attention stays within win x win windows of the grid:
    the tokens regrouped into windows, the block, and back."""
    n = grid // win
    D = x.shape[-1]
    xw = x.reshape(n, win, n, win, D).permute(0, 2, 1, 3, 4).reshape(
        n * n, win * win, D)
    xw = plain.block(xw, w, name, heads, precision)
    return xw.reshape(n, n, win, win, D).permute(0, 2, 1, 3, 4).reshape(
        1, grid * grid, D)


def features(cfg: dict, w: dict, img, precision: str) -> list:
    """One normalised (S, S, 3) image -> the pyramid's five (H, W, 256)
    maps, strides 4-64."""
    P, D = cfg["patch_size"], cfg["embed_dim"]
    grid = cfg["img_size"] // P
    x = plain.patch_embed(img[None], w["backbone.patch_embed.proj.weight"],
                          w["backbone.patch_embed.proj.bias"], P, precision)
    pe = w["backbone.pos_embed"][0, 1:].reshape(1, 14, 14, D).permute(
        0, 3, 1, 2)
    pe = F.interpolate(pe, size=(grid, grid), mode="bilinear",
                       align_corners=True)
    x = x + pe.permute(0, 2, 3, 1).reshape(1, grid * grid, D)
    for i in range(cfg["depth"]):
        name = f"backbone.blocks.{i}"
        if i in cfg["global_blocks"]:
            x = plain.block(x, w, name, cfg["num_heads"], precision)
        else:
            x = _window_blocks(x, w, name, cfg["num_heads"], precision, grid,
                               cfg["window_size"])
    eps = cfg["layer_norm_eps"]
    x = detection.layer_norm(x, w, "backbone.norm", eps).reshape(grid, grid,
                                                                 D)
    conv, deconv = detection.conv, detection.deconv2x

    def branch(y, name):
        y = detection.layer_norm(conv(y, w[f"fpn.{name}.proj.weight"],
                                      w[f"fpn.{name}.proj.bias"], precision),
                                 w, f"fpn.{name}.ln1", eps)
        return detection.layer_norm(conv(y, w[f"fpn.{name}.conv.weight"],
                                         w[f"fpn.{name}.conv.bias"],
                                         precision, padding=1),
                                    w, f"fpn.{name}.ln2", eps)

    up = lambda y, name: deconv(y, w[f"fpn.{name}.weight"],
                                w[f"fpn.{name}.bias"], precision)
    p32 = branch(x.reshape(grid // 2, 2, grid // 2, 2, D).amax(dim=(1, 3)),
                 "fpn1")
    p16 = branch(x, "fpn2")
    p8 = branch(up(x, "fpn3_deconv"), "fpn3")
    u4 = F.gelu(detection.layer_norm(up(x, "fpn4_deconv1"), w, "fpn.fpn4_ln",
                                     eps))
    p4 = branch(up(u4, "fpn4_deconv2"), "fpn4")
    return [p4, p8, p16, p32, p32[::2, ::2]]


def rpn_head(w: dict, levels: list, precision: str):
    """Per level the objectness (h w A,) and deltas (h w A, 4)."""
    obj, deltas = [], []
    for f in levels:
        t = F.relu(detection.conv(f, w["rpn.head.conv.weight"],
                                  w["rpn.head.conv.bias"], precision,
                                  padding=1))
        obj.append(detection.conv(t, w["rpn.head.cls_logits.weight"],
                                  w["rpn.head.cls_logits.bias"],
                                  "float32").reshape(-1))
        deltas.append(detection.conv(t, w["rpn.head.bbox_pred.weight"],
                                     w["rpn.head.bbox_pred.bias"],
                                     "float32").reshape(-1, 4))
    return obj, deltas


def proposals(cfg: dict, obj: list, deltas: list, anchors: list):
    """(boxes (k, 4), valid (k,)) the RPN keeps."""
    boxes, scores, levels, valid = detection.top_candidates(
        obj, deltas, anchors, cfg["img_size"], cfg["rpn_pre_nms_top_n_train"])
    idx, ok = detection.greedy_nms(boxes, scores, levels, valid,
                                   cfg["rpn_nms_thresh"],
                                   cfg["rpn_post_nms_top_n_train"])
    return boxes[idx], ok


def box_head(w: dict, feats, precision: str, classes: int):
    x = feats.reshape(feats.shape[0], -1)
    for fc in ("fc6", "fc7"):
        x = F.relu(plain.linear(x, w[f"roi_heads.box_head.{fc}.weight"],
                                w[f"roi_heads.box_head.{fc}.bias"],
                                precision))
    scores = plain.linear(x, w["roi_heads.box_predictor.cls_score.weight"],
                          w["roi_heads.box_predictor.cls_score.bias"],
                          "float32")
    deltas = plain.linear(x, w["roi_heads.box_predictor.bbox_pred.weight"],
                          w["roi_heads.box_predictor.bbox_pred.bias"],
                          "float32")
    return scores, deltas.reshape(-1, classes, 4)


def image_losses(cfg, w, img, gt, noise, anchors, precision, kept):
    """One image's RPN objectness and box losses (each over its number
    sampled) and its RoI sums (cross-entropy, box) and number sampled, on
    the proposals `kept` (boxes, valid) of the first pass."""
    levels = features(cfg, w, img, precision)
    obj, deltas = rpn_head(w, levels, precision)
    obj_l, box_l = detection.rpn_losses(
        noise["rpn"], torch.cat(anchors), torch.cat(obj), torch.cat(deltas),
        gt["gt_boxes"], gt["gt_valid"])
    boxes, cls, targets, pos = detection.roi_targets(
        noise["roi_sample"], kept[0], kept[1], gt["gt_boxes"],
        gt["gt_labels"], gt["gt_valid"], cfg["box_batch_size_per_image"],
        cfg["box_positive_fraction"])
    scores, box_deltas = box_head(
        w, detection.roi_align(levels[:4], boxes, cfg["roi_output_size"],
                               cfg["roi_sampling_ratio"]),
        precision, cfg["box_classes"])
    ce, reg = detection.roi_losses(scores, box_deltas, cls, targets, pos)
    return obj_l, box_l, ce, reg


def first_pass(cfg, w, img, gt, noise, anchors, precision):
    """Without gradients: the image's proposals and the number its RoI
    sampler takes."""
    with torch.no_grad():
        obj, deltas = rpn_head(w, features(cfg, w, img, precision),
                               precision)
        kept = proposals(cfg, obj, deltas, anchors)
        boxes = detection.roi_targets(
            noise["roi_sample"], kept[0], kept[1], gt["gt_boxes"],
            gt["gt_labels"], gt["gt_valid"], cfg["box_batch_size_per_image"],
            cfg["box_positive_fraction"])[0]
    return kept, boxes.shape[0]


def step_grads(cfg, traffic, w, batch, gt, draws, noise_gen, anchors,
               precision):
    """One step's losses (the four of the program's dict and their sum
    `loss`, each the mean of the microbatches') and gradients (a dict by
    leaf), microbatch by microbatch and image by image."""
    B = batch.shape[0]
    mb = batch.shape[0] // max(1, B // traffic["microbatch"])
    n_micro = B // mb
    rnd = plain.rounding(precision)
    grads = {n: torch.zeros_like(p) for n, p in w.items()}
    parts = dict.fromkeys(("loss", "loss_objectness", "loss_rpn_box_reg",
                           "loss_classifier", "loss_box_reg"), 0.0)
    n_anchors = sum(a.shape[0] for a in anchors)
    for m in range(n_micro):
        noise = detection.draw_noise(mb, n_anchors,
                                     cfg["rpn_post_nms_top_n_train"],
                                     noise_gen)
        rows = range(m * mb, (m + 1) * mb)
        images, gts, firsts = [], [], []
        for r, i in enumerate(rows):
            p = {k: (v[i:i + 1] if torch.is_tensor(v) else v)
                 for k, v in draws.items()}
            img, boxes = detection.augment_batch(
                batch[i:i + 1], gt["gt_boxes"][i:i + 1], p, rnd)
            images.append(augment.normalize(img[0]))
            gts.append({"gt_boxes": boxes[0], "gt_labels": gt["gt_labels"][i],
                        "gt_valid": gt["gt_valid"][i]})
            firsts.append(first_pass(cfg, w, images[-1], gts[-1],
                                     {k: v[r] for k, v in noise.items()},
                                     anchors, precision))
        n_sampled = max(sum(n for _, n in firsts), 1)
        for r in range(mb):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in w.items()}
            obj_l, box_l, ce, reg = image_losses(
                cfg, leaves, images[r], gts[r],
                {k: v[r] for k, v in noise.items()}, anchors, precision,
                firsts[r][0])
            terms = {"loss_objectness": obj_l / mb,
                     "loss_rpn_box_reg": box_l / mb,
                     "loss_classifier": ce / n_sampled,
                     "loss_box_reg": reg / n_sampled}
            loss = sum(terms.values())
            for n, g in zip(leaves, torch.autograd.grad(
                    loss / n_micro, list(leaves.values()))):
                grads[n] += g
            for key, v in {"loss": loss, **terms}.items():
                parts[key] += float(v.detach()) / n_micro
            del leaves, loss, terms, obj_l, box_l, ce, reg
    return parts, grads


def readings(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
             steps: int, precision: str = "float32") -> dict:
    """The first `steps` steps from `weights` on the pool's first batches
    and their ground truth, with the augmentation's and the samplers' draws
    replayed from `seed`: each step's loss, each leaf's first gradient and
    each leaf's change after the last step (`plain.leaf_norms`)."""
    device = next(iter(weights.values())).device
    aug_gen = inputs.generator(seed, inputs.STEP, "cpu")
    noise_gen = inputs.generator(seed, detection.MODEL_NOISE, device)
    gts = detection.draw_gt(traffic, seed, device)
    o = cfg["optimizer"]
    params = {n: p.detach().clone() for n, p in weights.items()}
    start = {n: p.clone() for n, p in params.items()}
    opt = plain.AdamW(params, o["b1"], o["b2"], o["eps"], o["weight_decay"])
    anchors = detection.anchors(cfg["img_size"], device)
    losses, grad_norms = [], {}
    with plain.no_tf32():
        for i in range(steps):
            k = i % len(data["batches"])
            img = data["batches"][k]["image"]
            draws = detection.draw_augment(img.shape[0], aug_gen)
            parts, grads = step_grads(cfg, traffic, params, img, gts[k],
                                      draws, noise_gen, anchors, precision)
            if i == 0:
                grad_norms = plain.norms(grads.items())
            losses.append(parts["loss"])
            opt.step(grads, o["lr"])
            del grads
    changes = plain.norms((n, p - start[n]) for n, p in params.items())
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": changes}
