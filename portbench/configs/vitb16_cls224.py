"""ViT-B/16 at 224 px with a linear head: the port's finetune step.

The window drives `ssl4gie_tpu_torch.core.trainer.make_full_step`'s
`full_step(model, optimizer, img_u8, labels, generator)`: the uint8 batch,
the classification augmentation on the card (jitter, 25-tap blur, flips,
the rotation kernel), the forward in bfloat16 over float32 masters (the
packed-QKV attention kernels at N = 197), the class-weighted
cross-entropy, the backward and AdamW, with a host generator for the
augmentation's draws, as `Trainer` runs it.
"""

from __future__ import annotations

import functools
import types

import torch

from portbench import inputs, work


def weight_specs(cfg: dict) -> list:
    D, P = cfg["embed_dim"], cfg["patch_size"]
    tokens = (cfg["img_size"] // P) ** 2 + 1
    specs = [("backbone.cls_token", (1, 1, D), 0.0),
             ("backbone.pos_embed", (1, tokens, D), 0.0),
             ("backbone.patch_embed.proj.weight", (D, 3, P, P), 0.0),
             ("backbone.patch_embed.proj.bias", (D,), 0.0)]
    for i in range(cfg["depth"]):
        specs += inputs.block_specs(f"backbone.blocks.{i}", D, cfg["mlp_dim"])
    return specs + [("backbone.norm.weight", (D,), 1.0),
                    ("backbone.norm.bias", (D,), 0.0),
                    ("lin_head.weight", (cfg["num_classes"], D), 0.0),
                    ("lin_head.bias", (cfg["num_classes"],), 0.0)]


def flops_per_image(cfg: dict) -> float:
    return work.train_flops(work.vit_classifier_forward_flops(
        cfg["img_size"], cfg["patch_size"], cfg["embed_dim"], cfg["mlp_dim"],
        cfg["depth"], cfg["num_heads"], cfg["num_classes"]))


def attention(cfg: dict, batch: int) -> list:
    """The softmax attention a step needs: every block over all tokens."""
    return [{"seqs": batch, "heads": cfg["num_heads"],
             "n": (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1,
             "dh": cfg["embed_dim"] // cfg["num_heads"],
             "layers": cfg["depth"]}]


def build(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
          device) -> types.SimpleNamespace:
    """The port's model with `weights`, its AdamW and the full step."""
    from ssl4gie_tpu_torch.core.train_state import make_adamw
    from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
    from ssl4gie_tpu_torch.metrics.classification import \
        weighted_cross_entropy
    from ssl4gie_tpu_torch.models.vit import ViTClassifier

    if cfg["mlp_dim"] != 4 * cfg["embed_dim"]:
        raise ValueError("the port's ViT takes an MLP of 4 x embed_dim")
    model = ViTClassifier(cfg["num_classes"], img_size=cfg["img_size"],
                          dtype=getattr(torch, cfg["compute_dtype"]),
                          depth=cfg["depth"], embed_dim=cfg["embed_dim"],
                          num_heads=cfg["num_heads"], device=device)
    model.load_state_dict(weights, strict=True)
    o = cfg["optimizer"]
    optimizer = make_adamw(model.parameters(), o["lr"], o["b1"], o["b2"],
                           o["eps"], o["weight_decay"])
    task = TaskDefinition(
        name="classification", aug_mode="classification", target_key="label",
        loss_fn=functools.partial(weighted_cross_entropy,
                                  class_weights=data["class_weights"]),
        eval_kind="accumulate_preds")
    full_step = make_full_step(task, exact=False, per_image_jitter=False)
    gen = inputs.generator(seed, inputs.STEP, "cpu")

    def step(i: int, batch: dict) -> torch.Tensor:
        return full_step(model, optimizer, batch["image"], batch["label"],
                         gen)["loss"]

    return types.SimpleNamespace(model=model, optimizer=optimizer, step=step)
