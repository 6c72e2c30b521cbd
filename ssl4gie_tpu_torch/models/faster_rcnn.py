"""Faster R-CNN with the ViTDet backbone (port of
`ssl4gie_tpu/models/faster_rcnn.py`).

The reference's ViT-B detector (`FasterRCNN(backbone=ViTDet)` at a fixed
1024 px canvas): images arrive pre-padded to a fixed square, proposal and
detection counts are fixed top-k with validity masks, NMS is the exact
greedy slot loop (`ops/nms.py`), RoIAlign the single-pass gather
(`ops/roi_align.py`). ImageNet normalization happens inside the model, as in
torchvision's GeneralizedRCNNTransform. Module names follow torchvision
where the JAX tree has a counterpart: `backbone`, `fpn`,
`rpn.head.conv/cls_logits/bbox_pred`, `roi_heads.box_head.fc6/fc7`,
`roi_heads.box_predictor.cls_score/bbox_pred`.

Dtypes as the JAX package: the backbone and FPN run in the compute dtype and
their outputs are cast to float32; the RPN's 3x3 conv runs in the compute
dtype and its 1x1 heads in float32; the box head's fc6 and fc7 run in the
compute dtype and its predictor in float32.

Randomness is injected: the train forward's samplers take uniform noise
(`noise`, see `draw_noise`), drawn from a `torch.Generator` when not given.
The RN50 detector (`arch="resnet50"`) and the batch-max emulation
(`content_sizes`) raise until the dense slice. The weights are drawn on the
CPU, then moved to `device`: the card when none is given (no card raises;
`device="cpu"` builds on the CPU).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ssl4gie_tpu_torch.data.augment import normalize
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.models.roi_heads import (BoxHead, assign_proposals,
                                                extract_roi_features,
                                                postprocess_detections,
                                                roi_head_loss)
from ssl4gie_tpu_torch.models.rpn import (RPNHead, generate_anchors, rpn_loss,
                                          select_proposals)
from ssl4gie_tpu_torch.models.vit import ViTBackbone
from ssl4gie_tpu_torch.models.vitdet_fpn import ViTDetFPN

STRIDES = (4, 8, 16, 32, 64)
MAX_GT = 16


@lru_cache(maxsize=8)
def _anchor_lattice(shapes: tuple, device: torch.device):
    """The anchors of the levels `shapes` on `device` (made once) and each
    level's (start, end) in them."""
    anchors = torch.from_numpy(generate_anchors(shapes, STRIDES)).to(device)
    sizes = [h * w * 3 for h, w in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return anchors, [(offs[i], offs[i + 1]) for i in range(len(sizes))]


class RPN(nn.Module):
    def __init__(self, in_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.head = RPNHead(in_channels, dtype=dtype)


class FasterRCNN(nn.Module):
    def __init__(self, arch: str = "vit_b", num_classes: int = 2,
                 image_size: int = 1024, pos_embed_type: str = "learned",
                 rpn_pre_nms_top_n_train: int = 2000,
                 rpn_pre_nms_top_n_test: int = 1000,
                 rpn_post_nms_top_n_train: int = 1000,
                 rpn_post_nms_top_n_test: int = 1000,
                 rpn_nms_thresh: float = 0.7,
                 box_batch_size_per_image: int = 512,
                 box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 detections_per_img: int = 100, fpn_ln_mode: str = "channel",
                 dtype=torch.float32, depth: int = 12, embed_dim: int = 768,
                 num_heads: int = 12,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if arch != "vit_b":
            raise NotImplementedError(f"arch {arch!r}: only 'vit_b' is ported; "
                                      "the RN50 detector (ResNetFPN) is not "
                                      "ported yet")
        device = default_device(device)
        self.image_size = image_size
        self.dtype = dtype
        self.rpn_pre_nms_top_n = (rpn_pre_nms_top_n_train,
                                  rpn_pre_nms_top_n_test)
        self.rpn_post_nms_top_n = (rpn_post_nms_top_n_train,
                                   rpn_post_nms_top_n_test)
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_batch_size_per_image = box_batch_size_per_image
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.detections_per_img = detections_per_img
        self.backbone = ViTBackbone(img_size=image_size, mode="det",
                                    pos_embed_type=pos_embed_type,
                                    embed_dim=embed_dim, depth=depth,
                                    num_heads=num_heads, dtype=dtype)
        self.fpn = ViTDetFPN(embed_dim, 256, dtype=dtype, ln_mode=fpn_ln_mode,
                             grid=image_size // 16)
        self.rpn = RPN(256, dtype=dtype)
        self.roi_heads = BoxHead(256, num_classes, dtype=dtype)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.fpn.reset_parameters(generator)
        self.rpn.head.reset_parameters(generator)
        self.roi_heads.reset_parameters(generator)

    def noise_shapes(self, batch: int) -> dict:
        """Shapes of the train forward's sampler noise for a batch."""
        g = self.image_size
        shapes = tuple((g // s, g // s) for s in STRIDES)
        n_anchors = sum(h * w * 3 for h, w in shapes)
        n_props = self.rpn_post_nms_top_n[0] + MAX_GT
        return {"rpn": (batch, n_anchors), "roi_sample": (batch, n_props),
                "roi_tie": (batch, n_props)}

    def draw_noise(self, batch: int, generator: torch.Generator) -> dict:
        """U[0, 1) noise for the RPN anchor sampler, the RoI sampler and the
        RoI top-k tie-break, on the generator's device."""
        return {k: torch.rand(s, generator=generator, device=generator.device)
                for k, s in self.noise_shapes(batch).items()}

    def forward(self, images, gt_boxes=None, gt_labels=None, gt_valid=None,
                train: bool = False, noise: dict | None = None,
                generator: torch.Generator | None = None,
                content_sizes=None):
        """images: (B, S, S, 3) float in [0, 1] (pre-padded square). Train:
        returns the four losses. Eval: the detections, (B, D, ...) each.
        gt_boxes (B, MAX_GT, 4), gt_labels (B, MAX_GT), gt_valid (B, MAX_GT);
        `noise` as `draw_noise` gives it, else drawn from `generator`."""
        if content_sizes is not None:
            raise NotImplementedError("content_sizes (the RN50 batch-max "
                                      "emulation) is not ported")
        B = images.shape[0]
        x = normalize(images.to(torch.float32)).to(self.dtype)
        fmap = self.backbone(x)
        feats = [f.to(torch.float32) for f in self.fpn(fmap)]
        objectness, deltas = self.rpn.head(feats)

        shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
        anchors, level_slices = _anchor_lattice(shapes, images.device)
        phase = 0 if train else 1
        proposals, prop_valid = select_proposals(
            objectness, deltas, anchors, level_slices, self.image_size,
            self.rpn_pre_nms_top_n[phase], self.rpn_post_nms_top_n[phase],
            self.rpn_nms_thresh)
        proposals = proposals.detach()
        head = self.roi_heads

        if train:
            if noise is None:
                if generator is None:
                    raise ValueError("the train forward needs `noise` or a "
                                     "generator")
                noise = self.draw_noise(B, generator)
            noise = {k: v.to(images.device) for k, v in noise.items()}
            obj_l, box_l = rpn_loss(noise["rpn"], anchors, objectness, deltas,
                                    gt_boxes, gt_valid)
            boxes_s, cls_labels, reg_targets, pos_mask, sampled_valid = \
                assign_proposals(noise["roi_sample"], noise["roi_tie"],
                                 proposals, prop_valid, gt_boxes, gt_labels,
                                 gt_valid, self.box_batch_size_per_image)
            roi_feats = extract_roi_features(feats, boxes_s)
            S = roi_feats.shape[1]
            scores, box_deltas = head(roi_feats.reshape(B * S, 7, 7, -1))
            cls_loss, reg_loss = roi_head_loss(
                scores, box_deltas, cls_labels.reshape(-1),
                reg_targets.reshape(-1, 4), pos_mask.reshape(-1),
                sampled_valid.reshape(-1))
            return {"loss_objectness": obj_l.mean(),
                    "loss_rpn_box_reg": box_l.mean(),
                    "loss_classifier": cls_loss,
                    "loss_box_reg": reg_loss}

        roi_feats = extract_roi_features(feats, proposals)
        R = roi_feats.shape[1]
        scores, box_deltas = head(roi_feats.reshape(B * R, 7, 7, -1))
        K = scores.shape[-1]
        return postprocess_detections(
            scores.reshape(B, R, K), box_deltas.reshape(B, R, K, 4),
            proposals, prop_valid, self.image_size,
            score_thresh=self.box_score_thresh,
            nms_thresh=self.box_nms_thresh,
            detections_per_img=self.detections_per_img)


def build_detector(architecture: str, pos_embed_type: str = "learned",
                   img_size: int = 1024, dtype=torch.float32,
                   num_classes: int = 2, fpn_ln_mode: str = "channel",
                   **kwargs) -> FasterRCNN:
    """`architecture`: "vit_b" (or `Architecture.VIT_B`); anything else is
    the RN50 detector, which raises until it is ported."""
    arch = "vit_b" if str(getattr(architecture, "value", architecture)) \
        == "vit_b" else "resnet50"
    return FasterRCNN(arch=arch, num_classes=num_classes, image_size=img_size,
                      pos_embed_type=pos_embed_type, dtype=dtype,
                      fpn_ln_mode=fpn_ln_mode, **kwargs)
