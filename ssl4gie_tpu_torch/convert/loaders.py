"""Pretrained weights into a built model's backbone (port of
`ssl4gie_tpu/convert/loaders.py`).

As the reference's factories (`utils.py:4-81`) and each task's build(), the
SSL or ImageNet weights land in the backbone (or encoder) of whatever task
model was built: the classifier's, the dense model's, DeepLabV3+'s, the
depth model's `encoder`, the ViT-B detector's `backbone` or the RN50-FPN
detector's `backbone.body`. A checkpoint is a torch file: one of the
port's own exports (`ssl/pretrain.py`: `{'params': ..., 'meta': ...}`, a
MoCo export's encoder under `backbone.`) or `cli/convert.py`'s, or a
reference `.pth`/`.pth.tar` in any of the formats `convert/torch_names.py`
names. The JAX package's Orbax directories are not read (the card machine
has no orbax). Each tensor whose name the backbone has is copied in, in
the backbone's dtype; a shape mismatch raises; names the backbone lacks
are ignored, as the reference's `load_my_state_dict` does.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ssl4gie_tpu_torch.convert.torch_names import (resnet_encoder,
                                                   strip_prefixes,
                                                   vit_encoder,
                                                   vit_from_augreg_npz)
from ssl4gie_tpu_torch.core.config import Architecture

VIT_NPZ_ENV = "SSL4GIE_IMAGENET_VIT_NPZ"
RN50_PTH_ENV = "SSL4GIE_IMAGENET_RN50_PTH"


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file's tensors by name, unwrapped and stripped
    (`strip_prefixes`); of a port export, its parameters, and of a MoCo
    export, its encoder's backbone (`backbone.` stripped)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: the port reads torch "
                         "checkpoint files only (its own exports or the "
                         "reference's .pth), not Orbax slots")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if "params" in obj and isinstance(obj["params"], dict):
        obj = obj["params"]
    sd = {k: torch.as_tensor(v) for k, v in strip_prefixes(obj).items()
          if hasattr(v, "shape")}
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items()
              if k.startswith("backbone.")}
    return sd


def backbone_of(model: torch.nn.Module) -> torch.nn.Module:
    """The module the encoder's weights land in: `backbone` or `encoder`
    (the JAX package's `_backbone_key`), the body of an FPN backbone, or
    the model itself when it has neither (a bare backbone)."""
    for name in ("backbone", "encoder"):
        sub = getattr(model, name, None)
        if isinstance(sub, torch.nn.Module):
            return getattr(sub, "body", sub)
    return model


@torch.no_grad()
def merge_into(module: torch.nn.Module,
               update: Dict[str, torch.Tensor]) -> int:
    """Copy each tensor of `update` whose name `module`'s state dict has
    into it, in place and in the module's dtype; a shape mismatch raises.
    Returns the count copied."""
    target = module.state_dict()
    n = 0
    for k, v in update.items():
        if k not in target:
            continue
        if tuple(target[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(target[k].shape)} vs {tuple(v.shape)}")
        target[k].copy_(v)
        n += 1
    return n


def load_vit_encoder(path: str, module: torch.nn.Module) -> int:
    """A ViT checkpoint's encoder into `module` (a ViT backbone)."""
    return merge_into(module, vit_encoder(read_state_dict(path)))


def load_resnet_encoder(path: str, module: torch.nn.Module) -> int:
    """A torchvision-named ResNet-50 checkpoint's body (BatchNorm running
    statistics included) into `module` (a ResNet-50)."""
    return merge_into(module, resnet_encoder(read_state_dict(path)))


def load_pretrained(cfg, model: torch.nn.Module) -> int:
    """cfg.checkpoint into the model's backbone (`backbone_of`): a ViT
    encoder for vit_b, a ResNet-50 body otherwise. Returns the count of
    tensors loaded."""
    module = backbone_of(model)
    if cfg.architecture == Architecture.VIT_B:
        n = load_vit_encoder(cfg.checkpoint, module)
    else:
        n = load_resnet_encoder(cfg.checkpoint, module)
    print(f"Loaded {n} converted tensors from {cfg.checkpoint}")
    return n


def _env_path(name: str) -> str:
    path = os.environ.get(name)
    if not path:
        raise FileNotFoundError(f"set {name} to a local file: the "
                                "supervised ImageNet weights are not "
                                "downloaded")
    return path


def load_imagenet_supervised(cfg, model: torch.nn.Module) -> int:
    """The supervised ImageNet init from a local file (no egress): the
    timm AugReg .npz at $SSL4GIE_IMAGENET_VIT_NPZ or the torchvision RN50
    checkpoint at $SSL4GIE_IMAGENET_RN50_PTH (the files the reference
    downloads, `Models/models.py:286-290,70-75`); raises when unset.
    Returns the count of tensors loaded."""
    module = backbone_of(model)
    if cfg.architecture == Architecture.VIT_B:
        return merge_into(module, vit_from_augreg_npz(
            np.load(_env_path(VIT_NPZ_ENV))))
    return load_resnet_encoder(_env_path(RN50_PTH_ENV), module)
