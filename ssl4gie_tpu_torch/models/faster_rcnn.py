"""Faster R-CNN with the ViTDet or the RN50-FPN backbone (port of
`ssl4gie_tpu/models/faster_rcnn.py`).

The reference's two detectors: the ViT-B detector (`arch="vit_b"`,
`FasterRCNN(backbone=ViTDet)` at a fixed 1024 px canvas) and the RN50
detector (`arch="resnet50"`, `fasterrcnn_resnet50_fpn`, whose canvas is
torchvision's 1333 rounded up to 1344). Images arrive pre-padded to a fixed
square, proposal and detection counts are fixed top-k with validity masks,
NMS is the exact greedy slot loop (`ops/nms.py`), RoIAlign the single-pass
gather (`ops/roi_align.py`). ImageNet normalization happens inside the
model, as in torchvision's GeneralizedRCNNTransform. Module names follow
torchvision where the JAX tree has a counterpart: `backbone` (with `fpn`
beside it for the ViT, inside it for the RN50: `backbone.body`,
`backbone.fpn.inner_blocks`, `backbone.fpn.layer_blocks`),
`rpn.head.conv/cls_logits/bbox_pred`, `roi_heads.box_head.fc6/fc7`,
`roi_heads.box_predictor.cls_score/bbox_pred`.

Dtypes as the JAX package: the backbone and FPN run in the compute dtype and
their outputs are cast to float32; the RPN's 3x3 conv runs in the compute
dtype and its 1x1 heads in float32; the box head's fc6 and fc7 run in the
compute dtype and its predictor in float32.

Randomness is injected: the train forward's samplers take uniform noise
(`noise`, see `draw_noise`), drawn from a `torch.Generator` when not given.
The RN50 body's BatchNorms keep their running statistics under
`model.train()` (`vitdet_fpn.ResNetFPN`). The weights are drawn on the CPU,
then moved to `device`: the card when none is given (no card raises;
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
from ssl4gie_tpu_torch.models.rpn import (RPNHead, anchor_grid_info,
                                          generate_anchors, rpn_loss,
                                          select_proposals)
from ssl4gie_tpu_torch.models.vit import ViTBackbone
from ssl4gie_tpu_torch.models.vitdet_fpn import ResNetFPN, ViTDetFPN
from ssl4gie_tpu_torch.parallel.distributed import draw_global

STRIDES = (4, 8, 16, 32, 64)
MAX_GT = 16


@lru_cache(maxsize=8)
def _anchor_lattice(shapes: tuple, device: torch.device):
    """The anchors of the levels `shapes` on `device` (made once), each
    level's (start, end) in them, and each anchor's (gx, gy, stride)."""
    anchors = torch.from_numpy(generate_anchors(shapes, STRIDES)).to(device)
    grid = torch.from_numpy(anchor_grid_info(shapes, STRIDES)).to(device)
    sizes = [h * w * 3 for h, w in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return (anchors, [(offs[i], offs[i + 1]) for i in range(len(sizes))],
            grid)


def level_shapes(image_size: int) -> tuple:
    """The (h, w) of the five levels on a square canvas: strides 4-32, then
    the stride-2 subsample of the stride-32 level."""
    s32 = image_size // 32
    return tuple((image_size // s,) * 2 for s in STRIDES[:4]) + \
        (((s32 + 1) // 2,) * 2,)


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
        if arch not in ("vit_b", "resnet50"):
            raise ValueError(f"arch {arch!r} not in ('vit_b', 'resnet50')")
        device = default_device(device)
        self.arch = arch
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
        if arch == "vit_b":
            self.backbone = ViTBackbone(img_size=image_size, mode="det",
                                        pos_embed_type=pos_embed_type,
                                        embed_dim=embed_dim, depth=depth,
                                        num_heads=num_heads, dtype=dtype)
            self.fpn = ViTDetFPN(embed_dim, 256, dtype=dtype,
                                 ln_mode=fpn_ln_mode, grid=image_size // 16)
        else:
            self.backbone = ResNetFPN(256, dtype=dtype)
        self.rpn = RPN(256, dtype=dtype)
        self.roi_heads = BoxHead(256, num_classes, dtype=dtype)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        if self.arch == "vit_b":
            self.fpn.reset_parameters(generator)
        self.rpn.head.reset_parameters(generator)
        self.roi_heads.reset_parameters(generator)

    def noise_shapes(self, batch: int) -> dict:
        """Shapes of the train forward's sampler noise for a batch."""
        n_anchors = sum(h * w * 3 for h, w in level_shapes(self.image_size))
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
        `noise` as `draw_noise` gives it, else drawn from `generator`.

        content_sizes: optional (B, 2) integer (w, h) pre-pad extents of
        top-left placed images (the RN50 / `resize="torchvision"` prep); eval
        only, train ignores it. It reproduces torchvision's padding of a
        batch to its largest image, rounded up to /32: anchors beyond that
        extent are masked out of the RPN's top-k; proposals and detections
        are clipped to each image's own extent before their NMS; for the
        RN50 backbone the maps are masked at the extent (`ResNetFPN`) and
        RoIAlign's border rules apply there. The extents stay tensors on the
        device."""
        B = images.shape[0]
        x = normalize(images.to(torch.float32)).to(self.dtype)
        extent = mask_hw = None
        if content_sizes is not None and not train:
            content_sizes = torch.as_tensor(content_sizes,
                                            device=images.device)
            extent = ((content_sizes.max(dim=0).values + 31) // 32) * 32
            if self.arch == "resnet50":
                mask_hw = (extent[1], extent[0])
        if self.arch == "vit_b":
            feats = self.fpn(self.backbone(x))
        else:
            feats = self.backbone(x, mask_hw=mask_hw)
        feats = [f.to(torch.float32) for f in feats]
        objectness, deltas = self.rpn.head(feats)

        shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
        anchors, level_slices, grid = _anchor_lattice(shapes, images.device)
        anchor_valid = content_wh = None
        if extent is not None:
            content_wh = content_sizes
            st = grid[:, 2]
            anchor_valid = ((grid[:, 0] < (extent[0] + st - 1) // st)
                            & (grid[:, 1] < (extent[1] + st - 1) // st))
        phase = 0 if train else 1
        proposals, prop_valid = select_proposals(
            objectness, deltas, anchors, level_slices, self.image_size,
            self.rpn_pre_nms_top_n[phase], self.rpn_post_nms_top_n[phase],
            self.rpn_nms_thresh, anchor_valid=anchor_valid,
            content_wh=content_wh)
        proposals = proposals.detach()
        head = self.roi_heads

        if train:
            if noise is None:
                if generator is None:
                    raise ValueError("the train forward needs `noise` or a "
                                     "generator")
                noise = draw_global(self.draw_noise, B, generator)
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

        roi_extent = None
        if mask_hw is not None:
            roi_extent = torch.stack([torch.stack([mask_hw[0] // s,
                                                   mask_hw[1] // s])
                                      for s in STRIDES[:4]]).float()
        roi_feats = extract_roi_features(feats, proposals,
                                         extent_hw=roi_extent)
        R = roi_feats.shape[1]
        scores, box_deltas = head(roi_feats.reshape(B * R, 7, 7, -1))
        K = scores.shape[-1]
        return postprocess_detections(
            scores.reshape(B, R, K), box_deltas.reshape(B, R, K, 4),
            proposals, prop_valid, self.image_size,
            score_thresh=self.box_score_thresh,
            nms_thresh=self.box_nms_thresh,
            detections_per_img=self.detections_per_img,
            content_wh=content_wh)


def build_detector(architecture: str, pos_embed_type: str = "learned",
                   img_size: int = 1024, dtype=torch.float32,
                   num_classes: int = 2, fpn_ln_mode: str = "channel",
                   **kwargs) -> FasterRCNN:
    """`architecture`: "vit_b" (or `Architecture.VIT_B`); anything else is
    the RN50 detector."""
    arch = "vit_b" if str(getattr(architecture, "value", architecture)) \
        == "vit_b" else "resnet50"
    return FasterRCNN(arch=arch, num_classes=num_classes, image_size=img_size,
                      pos_embed_type=pos_embed_type, dtype=dtype,
                      fpn_ln_mode=fpn_ln_mode, **kwargs)
