"""The plain reference of `vitb16_cls224`: timm's VisionTransformer
(`vit_base_patch16_224`: pre-norm blocks, exact GELU, LayerNorm eps 1e-6,
the cls token's output through a linear head) in float32, the
class-weighted cross-entropy (torch's `F.cross_entropy(weight=w)`), the
classification augmentation of `reference/augment.py` and AdamW.

Imports nothing of the program. Departure from timm: none in the
mathematics; the 16 x 16 patch convolution is written as the product it
is.
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.reference import augment, plain


def loss_fn(cfg: dict, class_weights: torch.Tensor, precision: str):
    heads = cfg["num_heads"]

    def loss(w: dict, batch: dict) -> torch.Tensor:
        x = plain.patch_embed(batch["image"], w["backbone.patch_embed.proj"
                                                ".weight"],
                              w["backbone.patch_embed.proj.bias"],
                              cfg["patch_size"], precision)
        B, _, D = x.shape
        x = torch.cat([w["backbone.cls_token"].expand(B, 1, D), x], dim=1)
        x = x + w["backbone.pos_embed"]
        for i in range(cfg["depth"]):
            x = plain.block(x, w, f"backbone.blocks.{i}", heads, precision)
        feat = plain.layer_norm(x, w, "backbone.norm")[:, 0]
        # the head computes in float32 in the program too
        logits = plain.linear(feat, w["lin_head.weight"], w["lin_head.bias"],
                              "float32")
        return torch.nn.functional.cross_entropy(
            logits, batch["label"], weight=class_weights)

    return loss


def readings(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
             steps: int, precision: str = "float32") -> dict:
    """The first `steps` steps from `weights` on the pool's first batches,
    with the step's augmentation draws replayed from `seed`."""
    gen = inputs.generator(seed, inputs.STEP, "cpu")
    o = cfg["optimizer"]
    params = {n: p.detach().clone() for n, p in weights.items()}
    opt = plain.AdamW(params, o["b1"], o["b2"], o["eps"], o["weight_decay"])
    with plain.no_tf32():
        batches = []
        for i in range(steps):
            b = data["batches"][i % len(data["batches"])]
            draws = augment.draw_classification(b["image"].shape[0], gen)
            batches.append({"image": augment.classification(
                b["image"], draws, plain.rounding(precision)),
                "label": b["label"]})
        return plain.train_readings(
            params, loss_fn(cfg, data["class_weights"], precision), batches,
            [o["lr"]] * steps, opt)
