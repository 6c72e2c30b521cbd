"""Model wiring (port of `ssl4gie_tpu/models/factory.py`): the ViT dense
model, and the ResNet-50 models the JAX factory builds
(`models/resnet.py:ResNetClassifier`, `ResNetDepthModel`;
`models/deeplabv3plus.py:DeepLabV3Plus`), exported here with the same
`generator=` / `device=` contract. The ViT classifier is
`models/vit.py:ViTClassifier`; the detector
`models/faster_rcnn.py:FasterRCNN`."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ssl4gie_tpu_torch.models.deeplabv3plus import DeepLabV3Plus
from ssl4gie_tpu_torch.models.dpt import DPTDecoder
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.models.resnet import ResNetClassifier, ResNetDepthModel
from ssl4gie_tpu_torch.models.vit import DENSE_TAPS, ViTBackbone

__all__ = ["ViTDenseModel", "DeepLabV3Plus", "ResNetClassifier",
           "ResNetDepthModel"]


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
