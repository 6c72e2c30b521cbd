"""Layer-wise learning-rate decay (port of `ssl4gie_tpu/ssl/lr_decay.py`;
the BEiT/ELECTRA scheme of `Models/mae/util/lr_decay.py:15-75`).

Each parameter's learning rate is scaled by decay^(num_layers - layer_id),
num_layers = depth + 1: layer 0 is the patch embedding, the position
embedding and the cls token, layer i + 1 is block i, and everything else
(the final norm, the head) is layer depth + 1, scale 1. torch applies a
param group's `lr` to both the Adam step and the decoupled weight decay,
which is what the JAX package's `optax.chain(adamw, scale_by_layer_decay)`
does, so each scale becomes one AdamW param group (`lr_scale`), and
`core/train_state.py:set_lr` keeps the ratios when the plateau moves the
base rate.
"""

from __future__ import annotations

import torch


def vit_layer_id(name: str, depth: int = 12) -> int:
    """The layer id of a parameter of the port's ViT models by its name
    (`backbone.blocks.{i}.`, `backbone.cls_token`, `backbone.pos_embed`,
    `backbone.patch_embed.*`, `lin_head.*`), as `get_layer_id_for_vit`
    (`lr_decay.py:64-79`)."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p in ("cls_token", "pos_embed") or p.startswith("patch_embed"):
            return 0
        if p == "blocks" and i + 1 < len(parts):
            return int(parts[i + 1]) + 1
    return depth + 1


def layer_decay_scales(model: torch.nn.Module, depth: int = 12,
                       decay: float = 0.75) -> dict[str, float]:
    """{parameter name: decay^(num_layers - layer_id)}."""
    return {name: decay ** (depth + 1 - vit_layer_id(name, depth))
            for name, _ in model.named_parameters()}


def layer_decay_groups(model: torch.nn.Module, depth: int = 12,
                       decay: float = 0.75, trainable=None) -> list[dict]:
    """The param groups of layer decay, one per scale, each with its
    `lr_scale`, over the model's parameters (or those of them in
    `trainable`), in the order of `named_parameters`."""
    keep = None if trainable is None else {id(p) for p in trainable}
    groups: dict[float, dict] = {}
    for name, scale in layer_decay_scales(model, depth, decay).items():
        p = model.get_parameter(name)
        if keep is not None and id(p) not in keep:
            continue
        groups.setdefault(scale, {"params": [], "lr_scale": scale})
        groups[scale]["params"].append(p)
    return list(groups.values())
