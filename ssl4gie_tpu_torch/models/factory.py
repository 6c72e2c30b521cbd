"""Model wiring (port of `ssl4gie_tpu/models/factory.py`): the ViT dense
model, the ResNet-50 models the JAX factory builds
(`models/resnet.py:ResNetClassifier`, `ResNetDepthModel`;
`models/deeplabv3plus.py:DeepLabV3Plus`), exported here with the same
`generator=` / `device=` contract, and `build_model`, which picks the model
of a (task, architecture) as the JAX factory does. The ViT classifier is
`models/vit.py:ViTClassifier`; the detector
`models/faster_rcnn.py:FasterRCNN`."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ssl4gie_tpu_torch.core.config import (Architecture, Pretraining,
                                           SSLFramework, Task)
from ssl4gie_tpu_torch.models.deeplabv3plus import DeepLabV3Plus
from ssl4gie_tpu_torch.models.dpt import DPTDecoder
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.models.resnet import ResNetClassifier, ResNetDepthModel
from ssl4gie_tpu_torch.models.vit import (DENSE_TAPS, ViTBackbone,
                                          ViTClassifier)

__all__ = ["ViTDenseModel", "DeepLabV3Plus", "ResNetClassifier",
           "ResNetDepthModel", "build_model", "pos_embed_type_for"]


class ViTDenseModel(nn.Module):
    """ViT-B/16 in dense mode + the DPT decoder: seg logits (B, H, W,
    num_classes) or the depth map (B, H, W, 1), float32 either way. The
    parameters sit under `backbone.` and `decoder.`, the JAX package's
    names; the BatchNorms' running statistics are buffers, updated in
    train mode.

    Weights are drawn from `generator` on the CPU (seed 0 when none is given),
    then moved to `device`: the card when none is given (no card raises;
    `device="cpu"` builds on the CPU). The widths default to ViT-B/16 and
    the reference's DPT; tests narrow them and may tap other blocks of a
    shallower backbone (the JAX backbone's `dense_taps` field)."""

    def __init__(self, num_classes: int = 1, dense: str = "seg",
                 pos_embed_type: str = "learned", img_size: int = 224,
                 dtype=torch.float32, depth: int = 12, embed_dim: int = 768,
                 num_heads: int = 12,
                 features: Sequence[int] = (96, 192, 384, 768),
                 fusion_features: int = 256,
                 dense_taps: tuple = DENSE_TAPS,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = default_device(device)
        self.backbone = ViTBackbone(img_size=img_size, embed_dim=embed_dim,
                                    depth=depth, num_heads=num_heads,
                                    mode="dense",
                                    pos_embed_type=pos_embed_type,
                                    dtype=dtype, dense_taps=dense_taps)
        self.decoder = DPTDecoder(num_classes=num_classes, dense=dense,
                                  vit_features=embed_dim, features=features,
                                  fusion_features=fusion_features, dtype=dtype)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.backbone.reset_parameters(gen)
        self.decoder.reset_parameters(gen)
        self.to(device)

    def forward(self, x, generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """x: (B, 224, 224, 3) NHWC. `generator` draws the seg head's
        dropout mask in train mode (or `dropout_mask` is that mask)."""
        taps = self.backbone(x, generator)
        return self.decoder(taps, generator, dropout_mask)


def pos_embed_type_for(pretraining: Pretraining,
                       framework: Optional[SSLFramework]) -> str:
    """MoCo v3 and MAE checkpoints carry fixed 2-D sin-cos position
    embeddings (`Models/moco_v3/vits.py:53-69`, `Models/mae/models_mae.py:
    65-72`); supervised timm and random init use learned ones."""
    if framework in (SSLFramework.MAE, SSLFramework.MOCOV3):
        return "sincos"
    return "learned"


def build_model(task: Task, architecture: Architecture, *,
                num_classes: int = 1,
                pretraining: Pretraining = Pretraining.RANDOM,
                framework: Optional[SSLFramework] = None,
                out_token: str = "cls", img_size: int = 224,
                dtype=torch.float32, drop_path: float = 0.0,
                probe_bn: bool = False,
                generator: torch.Generator | None = None, device=None,
                **widths) -> nn.Module:
    """The model of `task` and `architecture`, as the JAX factory builds it,
    with weights drawn from `generator` and placed on `device` (the card
    unless given). `widths` narrow the model (depth, embed_dim, num_heads,
    DPT features and taps for the ViT; stage_sizes for the ResNet-50),
    for tests. `probe_bn` adds the MAE linear probe's BatchNorm before the
    ViT classifier's head."""
    pet = pos_embed_type_for(pretraining, framework)
    vit = architecture == Architecture.VIT_B
    if drop_path > 0 and not (vit and task == Task.CLASSIFICATION):
        # the reference threads drop_path_rate into the MAE finetune ViT
        # only (`Models/mae/main_finetune.py:229`)
        raise ValueError("--drop-path applies to ViT classification only")
    if probe_bn and not (vit and task == Task.CLASSIFICATION):
        raise ValueError("probe_bn applies to the ViT classifier only")
    kw = dict(dtype=dtype, generator=generator, device=device, **widths)
    if task == Task.CLASSIFICATION:
        if vit:
            return ViTClassifier(num_classes, out_token=out_token,
                                 pos_embed_type=pet, img_size=img_size,
                                 drop_path_rate=drop_path, probe_bn=probe_bn,
                                 **kw)
        return ResNetClassifier(num_classes, **kw)
    if task == Task.SEGMENTATION:
        if vit:
            return ViTDenseModel(num_classes=1, dense="seg",
                                 pos_embed_type=pet, img_size=img_size, **kw)
        # RN50 segmentation is DeepLabV3+, as the reference's
        # (`train_segmentation.py:153`)
        return DeepLabV3Plus(num_classes=1, **kw)
    if task == Task.DEPTH:
        if vit:
            return ViTDenseModel(num_classes=1, dense="depth",
                                 pos_embed_type=pet, img_size=img_size, **kw)
        return ResNetDepthModel(**kw)
    if task == Task.DETECTION:
        from ssl4gie_tpu_torch.models.faster_rcnn import build_detector
        return build_detector(architecture, pos_embed_type=pet,
                              img_size=img_size, **kw)
    raise ValueError(f"unknown task {task}")
