"""The reference's factory names (port of `ssl4gie_tpu/utils/__init__.py`;
the reference's `utils.py:4-81`), so that code written against the
reference migrates mechanically.

Each returns an `nn.Module` with the pretrained weights loaded into its
backbone (`convert/loaders.py`), on `device` (the card unless given; no
card raises, `device="cpu"` builds on the CPU): the bare backbone (pooled
features) without `head` or `dense`, the classifier with `head`, the DPT
dense model (`dense="seg"|"depth"`) for the ViT, DeepLabV3+ or the RN50
depth model for the ResNet, or the Faster R-CNN with `det`. The weights
that no checkpoint gives are drawn from seed 0. With `frozen` the backbone
takes no gradient (the reference freezes the encoder, `Models/models.py:
138-140`).
"""

from __future__ import annotations

import numpy as np
import torch

from ssl4gie_tpu_torch.convert.loaders import (RN50_PTH_ENV, VIT_NPZ_ENV,
                                               _env_path, backbone_of,
                                               load_resnet_encoder,
                                               load_vit_encoder, merge_into)
from ssl4gie_tpu_torch.convert.torch_names import vit_from_augreg_npz
from ssl4gie_tpu_torch.models.layers import default_device


def _build(arch: str, head: bool, num_classes: int, dense, det: bool,
           out_token: str = "cls", pos_embed_type: str = "learned",
           fixed_size=None, device=None) -> torch.nn.Module:
    from ssl4gie_tpu_torch.models.factory import (DeepLabV3Plus,
                                                  ResNetClassifier,
                                                  ResNetDepthModel,
                                                  ViTDenseModel)
    from ssl4gie_tpu_torch.models.faster_rcnn import FasterRCNN
    from ssl4gie_tpu_torch.models.resnet import ResNet50
    from ssl4gie_tpu_torch.models.vit import ViTBackbone, ViTClassifier

    size = fixed_size or 224
    device = default_device(device)
    if det:
        return FasterRCNN(arch=arch, image_size=size,
                          pos_embed_type=pos_embed_type, device=device)
    if arch == "vit_b":
        if dense:
            return ViTDenseModel(num_classes=num_classes, dense=dense,
                                 pos_embed_type=pos_embed_type,
                                 img_size=size, device=device)
        if head:
            return ViTClassifier(num_classes, out_token=out_token,
                                 pos_embed_type=pos_embed_type,
                                 img_size=size, device=device)
        bare = ViTBackbone(img_size=size, mode="pooled", out_token=out_token,
                           pos_embed_type=pos_embed_type)
    elif dense == "depth":
        return ResNetDepthModel(device=device)
    elif dense == "seg":
        return DeepLabV3Plus(num_classes=1, device=device)
    elif head:
        return ResNetClassifier(num_classes, device=device)
    else:
        bare = ResNet50(mode="pooled")
    bare.reset_parameters(torch.Generator().manual_seed(0))
    return bare.to(device)


def _load(model: torch.nn.Module, weight_path, arch: str,
          frozen: bool) -> torch.nn.Module:
    if weight_path is not None:
        load = load_vit_encoder if arch == "vit_b" else load_resnet_encoder
        load(weight_path, backbone_of(model))
    if frozen:
        backbone_of(model).requires_grad_(False)
    return model


def get_BarlowTwins_backbone(weight_path, head, num_classes, frozen, dense,
                             device=None):
    model = _build("resnet50", head, num_classes, dense, False,
                   device=device)
    return _load(model, weight_path, "resnet50", frozen)


def get_MAE_backbone(weight_path, head, num_classes, frozen, dense, det,
                     fixed_size=None, out_token="cls", device=None):
    model = _build("vit_b", head, num_classes, dense, det, out_token,
                   "sincos", fixed_size, device)
    return _load(model, weight_path, "vit_b", frozen)


def get_MoCoV3_backbone(weight_path, arch, head, num_classes, frozen, dense,
                        det, fixed_size=None, out_token="cls", device=None):
    pet = "sincos" if arch == "vit_b" else "learned"
    model = _build(arch, head, num_classes, dense, det, out_token, pet,
                   fixed_size, device)
    return _load(model, weight_path, arch, frozen)


def get_ImageNet_or_random_ResNet(head, num_classes, frozen, dense,
                                  ImageNet_weights, device=None):
    model = _build("resnet50", head, num_classes, dense, False,
                   device=device)
    path = _env_path(RN50_PTH_ENV) if ImageNet_weights else None
    return _load(model, path, "resnet50", frozen)


def get_ImageNet_or_random_ViT(head, num_classes, frozen, dense, det,
                               ImageNet_weights, fixed_size=None,
                               out_token="cls", device=None):
    model = _build("vit_b", head, num_classes, dense, det, out_token,
                   fixed_size=fixed_size, device=device)
    if ImageNet_weights:
        merge_into(backbone_of(model), vit_from_augreg_npz(
            np.load(_env_path(VIT_NPZ_ENV))))
    return _load(model, None, "vit_b", frozen)
