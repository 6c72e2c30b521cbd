"""ViTDet-B Faster R-CNN at a 1024 px canvas: the port's detection step.

The window drives `ssl4gie_tpu_torch.tasks.detection.
make_detection_full_step(accum_steps)`'s `full_step(model, optimizer,
batch, generator, model_generator)`: the uint8 1024 px canvases and their
ground-truth boxes, `detection_augment` on the card (jitter, blur, a
quarter-turn and flips moving the boxes), then per microbatch the ViT over
4,096 tokens (8 windowed blocks on the window kernels, 4 global ones on the
flash kernels), the simple pyramid, the RPN with its NMS (the NMS kernel),
RoIAlign and the box head, the four losses and their backward, then AdamW
on the averaged gradients. The augmentation's draws come from a host
generator and the samplers' noise from a card generator, as
`DetectionTrainer` runs them; the ground truth of each pool batch comes
from `reference/detection.py:draw_gt`, which the reference calls too.
"""

from __future__ import annotations

import types

import torch

from portbench import inputs, work
from portbench.reference import detection


def microbatches(traffic: dict) -> int:
    """The steps a batch is cut into: batch / microbatch (1 below one
    microbatch)."""
    n = max(1, traffic["batch"] // traffic["microbatch"])
    if traffic["batch"] % n:
        raise ValueError(f"batch {traffic['batch']} is not a multiple of "
                         f"{n} microbatches")
    return n


def global_layers(cfg: dict) -> int:
    """The blocks of global attention within the configuration's depth."""
    return sum(b < cfg["depth"] for b in cfg["global_blocks"])


def weight_specs(cfg: dict) -> list:
    """(name, shape, offset) of every leaf of the port's FasterRCNN("vit_b")
    under its state-dict names."""
    D, P, F = cfg["embed_dim"], cfg["patch_size"], cfg["fpn_channels"]
    specs = [("backbone.patch_embed.proj.weight", (D, 3, P, P), 0.0),
             ("backbone.patch_embed.proj.bias", (D,), 0.0),
             ("backbone.pos_embed", (1, 14 * 14 + 1, D), 0.0)]
    for i in range(cfg["depth"]):
        specs += inputs.block_specs(f"backbone.blocks.{i}", D, cfg["mlp_dim"])
    specs += [("backbone.norm.weight", (D,), 1.0),
              ("backbone.norm.bias", (D,), 0.0)]

    def branch(name):
        return [(f"fpn.{name}.proj.weight", (F, D, 1, 1), 0.0),
                (f"fpn.{name}.proj.bias", (F,), 0.0),
                (f"fpn.{name}.ln1.weight", (F,), 1.0),
                (f"fpn.{name}.ln1.bias", (F,), 0.0),
                (f"fpn.{name}.conv.weight", (F, F, 3, 3), 0.0),
                (f"fpn.{name}.conv.bias", (F,), 0.0),
                (f"fpn.{name}.ln2.weight", (F,), 1.0),
                (f"fpn.{name}.ln2.bias", (F,), 0.0)]

    def deconv(name):
        return [(f"fpn.{name}.weight", (D, D, 2, 2), 0.0),
                (f"fpn.{name}.bias", (D,), 0.0)]

    specs += (branch("fpn1") + branch("fpn2") + deconv("fpn3_deconv")
              + branch("fpn3") + deconv("fpn4_deconv1")
              + [("fpn.fpn4_ln.weight", (D,), 1.0),
                 ("fpn.fpn4_ln.bias", (D,), 0.0)]
              + deconv("fpn4_deconv2") + branch("fpn4"))
    A, H, K = len(cfg["aspect_ratios"]), cfg["box_head_dim"], \
        cfg["box_classes"]
    R = cfg["roi_output_size"]
    return specs + [
        ("rpn.head.conv.weight", (F, F, 3, 3), 0.0),
        ("rpn.head.conv.bias", (F,), 0.0),
        ("rpn.head.cls_logits.weight", (A, F, 1, 1), 0.0),
        ("rpn.head.cls_logits.bias", (A,), 0.0),
        ("rpn.head.bbox_pred.weight", (4 * A, F, 1, 1), 0.0),
        ("rpn.head.bbox_pred.bias", (4 * A,), 0.0),
        ("roi_heads.box_head.fc6.weight", (H, F * R * R), 0.0),
        ("roi_heads.box_head.fc6.bias", (H,), 0.0),
        ("roi_heads.box_head.fc7.weight", (H, H), 0.0),
        ("roi_heads.box_head.fc7.bias", (H,), 0.0),
        ("roi_heads.box_predictor.cls_score.weight", (K, H), 0.0),
        ("roi_heads.box_predictor.cls_score.bias", (K,), 0.0),
        ("roi_heads.box_predictor.bbox_pred.weight", (4 * K, H), 0.0),
        ("roi_heads.box_predictor.bbox_pred.bias", (4 * K,), 0.0)]


def flops_per_image(cfg: dict) -> float:
    """A trained image's FLOPs by `work.py`'s convention (matmuls at 2 a
    MAC, times 3): the patch projection; the 8 windowed blocks over
    (grid / window)^2 windows of window^2 tokens and the 4 global ones
    over grid^2 tokens (their linear layers and their two attention
    products, apart); the pyramid's 2 x 2 deconvolutions, 1 x 1
    projections and 3 x 3 convolutions; the RPN's 3 x 3 convolution and
    its 1 x 1 heads over every level; the box head's fc6, fc7 and
    predictor over the sampled RoIs. RoIAlign, the NMS, the matching and
    the losses do no matmul and are not counted."""
    D, P, F = cfg["embed_dim"], cfg["patch_size"], cfg["fpn_channels"]
    grid = cfg["img_size"] // P
    win = cfg["window_size"]
    n_global = global_layers(cfg)
    n_window = cfg["depth"] - n_global
    windows = (grid // win) ** 2
    mlp, heads = cfg["mlp_dim"], cfg["num_heads"]
    lin = work.linear_flops
    total = lin(grid * grid, P * P * 3, D)
    total += windows * work.encoder_forward_flops(win * win, D, mlp,
                                                  n_window, heads)
    total += work.encoder_forward_flops(grid * grid, D, mlp, n_global, heads)

    def branch(hw):                  # 1 x 1 projection, 3 x 3 convolution
        return lin(hw * hw, D, F) + lin(hw * hw, 9 * F, F)

    def deconv(hw):                  # 2 x 2 stride 2, D -> D, hw input
        return lin(hw * hw, D, 4 * D)

    total += branch(grid // 2) + branch(grid)                    # s32, s16
    total += deconv(grid) + branch(2 * grid)                     # s8
    total += deconv(grid) + deconv(2 * grid) + branch(4 * grid)  # s4
    A = len(cfg["aspect_ratios"])
    cells = sum(h * w for h, w in detection.level_shapes(cfg["img_size"]))
    total += lin(cells, 9 * F, F) + lin(cells, F, 5 * A)
    R, H = cfg["roi_output_size"], cfg["box_head_dim"]
    total += lin(cfg["box_batch_size_per_image"], F * R * R, H) + \
        lin(cfg["box_batch_size_per_image"], H, H) + \
        lin(cfg["box_batch_size_per_image"], H, 5 * cfg["box_classes"])
    return work.train_flops(total)


def attention(cfg: dict, batch: int) -> list:
    """The softmax attention a step needs: the windowed blocks over batch x
    (grid / window)^2 windows of window^2 tokens, the global blocks over
    batch sequences of grid^2 tokens, each at the ViT's heads."""
    grid = cfg["img_size"] // cfg["patch_size"]
    win = cfg["window_size"]
    heads, dh = cfg["num_heads"], cfg["embed_dim"] // cfg["num_heads"]
    n_global = global_layers(cfg)
    return [{"seqs": batch * (grid // win) ** 2, "heads": heads,
             "n": win * win, "dh": dh, "layers": cfg["depth"] - n_global},
            {"seqs": batch, "heads": heads, "n": grid * grid, "dh": dh,
             "layers": n_global}]


def build(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
          device) -> types.SimpleNamespace:
    """The port's ViTDet-B Faster R-CNN with `weights`, its detection AdamW
    and the full step at the cell's microbatches; each pool batch gains its
    ground truth."""
    from ssl4gie_tpu_torch.core.train_state import make_adamw
    from ssl4gie_tpu_torch.models import vit
    from ssl4gie_tpu_torch.models.faster_rcnn import build_detector
    from ssl4gie_tpu_torch.tasks.detection import make_detection_full_step

    if (tuple(cfg["global_blocks"]) != vit.GLOBAL_ATTN_BLOCKS
            or cfg["window_size"] != vit.DET_WINDOW
            or cfg["mlp_dim"] != 4 * cfg["embed_dim"]
            or traffic["canvas"] != cfg["img_size"]):
        raise ValueError("the port's ViTDet takes global blocks "
                         f"{vit.GLOBAL_ATTN_BLOCKS}, windows of "
                         f"{vit.DET_WINDOW}, mlp_dim 4 x embed_dim and the "
                         "canvas as its image size")
    for batch, gt in zip(data["batches"],
                         detection.draw_gt(traffic, seed, device)):
        batch.update(gt)
    model = build_detector(
        "vit_b", img_size=cfg["img_size"],
        dtype=getattr(torch, cfg["compute_dtype"]),
        num_classes=cfg["box_classes"], fpn_ln_mode=cfg["fpn_ln_mode"],
        rpn_pre_nms_top_n_train=cfg["rpn_pre_nms_top_n_train"],
        rpn_post_nms_top_n_train=cfg["rpn_post_nms_top_n_train"],
        rpn_nms_thresh=cfg["rpn_nms_thresh"],
        box_batch_size_per_image=cfg["box_batch_size_per_image"],
        depth=cfg["depth"], embed_dim=cfg["embed_dim"],
        num_heads=cfg["num_heads"], device=device)
    model.load_state_dict(weights, strict=True)
    o = cfg["optimizer"]
    optimizer = make_adamw(model.parameters(), o["lr"], o["b1"], o["b2"],
                           o["eps"], o["weight_decay"], grad_clip=o["clip"])
    full_step = make_detection_full_step(microbatches(traffic))
    aug_gen = inputs.generator(seed, inputs.STEP, "cpu")
    noise_gen = inputs.generator(seed, detection.MODEL_NOISE, device)

    def step(i: int, batch: dict) -> torch.Tensor:
        return full_step(model, optimizer, batch, aug_gen,
                         noise_gen)["loss"]

    return types.SimpleNamespace(model=model, optimizer=optimizer, step=step)
