"""MAE ViT-B/16 (decoder 512 x 8, mask 0.75, norm-pix loss): the port's
pretraining step.

The window drives `ssl4gie_tpu_torch.ssl.pretrain.make_mae_full_step`'s
`full_step(model, optimizer, img_u8, generator, step)`: the uint8 256 px
canvases, `mae_augment` on the card (a random resized crop to 224 px and
a flip), the masking noise, the encoder over the kept 50 tokens (plain
attention, N < 160), the decoder over 197 (the packed-QKV kernels at Dh
32), the loss, the backward and AdamW at the recipe's rate, with a host
generator for the draws, as `run_loop` runs it. The fused MLP stays off,
as the CLI runs it.
"""

from __future__ import annotations

import types

import torch

from portbench import inputs, work


def weight_specs(cfg: dict) -> list:
    D, E, P = cfg["embed_dim"], cfg["decoder_embed_dim"], cfg["patch_size"]
    specs = [("cls_token", (1, 1, D), 0.0),
             ("mask_token", (1, 1, E), 0.0),
             ("patch_embed.proj.weight", (D, 3, P, P), 0.0),
             ("patch_embed.proj.bias", (D,), 0.0)]
    for i in range(cfg["depth"]):
        specs += inputs.block_specs(f"blocks.{i}", D, cfg["mlp_dim"])
    specs += [("norm.weight", (D,), 1.0), ("norm.bias", (D,), 0.0),
              ("decoder_embed.weight", (E, D), 0.0),
              ("decoder_embed.bias", (E,), 0.0)]
    for i in range(cfg["decoder_depth"]):
        specs += inputs.block_specs(f"decoder_blocks.{i}", E,
                                    cfg["decoder_mlp_dim"])
    return specs + [("decoder_norm.weight", (E,), 1.0),
                    ("decoder_norm.bias", (E,), 0.0),
                    ("decoder_pred.weight", (P * P * 3, E), 0.0),
                    ("decoder_pred.bias", (P * P * 3,), 0.0)]


def flops_per_image(cfg: dict) -> float:
    return work.train_flops(work.mae_forward_flops(
        cfg["img_size"], cfg["patch_size"], cfg["embed_dim"], cfg["mlp_dim"],
        cfg["depth"], cfg["num_heads"], cfg["decoder_embed_dim"],
        cfg["decoder_mlp_dim"], cfg["decoder_depth"],
        cfg["decoder_num_heads"], cfg["mask_ratio"]))


def attention(cfg: dict, batch: int) -> list:
    """The softmax attention a step needs: the encoder over the kept
    patches and cls, the decoder over every patch and cls."""
    grid = (cfg["img_size"] // cfg["patch_size"]) ** 2
    kept = int(grid * (1 - cfg["mask_ratio"])) + 1
    return [{"seqs": batch, "heads": cfg["num_heads"], "n": kept,
             "dh": cfg["embed_dim"] // cfg["num_heads"],
             "layers": cfg["depth"]},
            {"seqs": batch, "heads": cfg["decoder_num_heads"], "n": grid + 1,
             "dh": cfg["decoder_embed_dim"] // cfg["decoder_num_heads"],
             "layers": cfg["decoder_depth"]}]


def build(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
          device) -> types.SimpleNamespace:
    """The port's MAE with `weights`, its AdamW, the recipe's schedule and
    the full step."""
    from ssl4gie_tpu_torch.core.config import PretrainConfig
    from ssl4gie_tpu_torch.models import layers
    from ssl4gie_tpu_torch.ssl.mae import MAE
    from ssl4gie_tpu_torch.ssl.pretrain import (make_mae_full_step,
                                                make_mae_optimizer,
                                                make_schedule)

    for key in ("mlp_dim", "decoder_mlp_dim"):
        width = cfg["embed_dim" if key == "mlp_dim" else "decoder_embed_dim"]
        if cfg[key] != 4 * width:
            raise ValueError(f"the port's MAE takes {key} = 4 x {width}")
    layers.FUSED_MLP = cfg["fused_mlp"]     # the module's documented switch
    model = MAE(img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                num_heads=cfg["num_heads"],
                decoder_embed_dim=cfg["decoder_embed_dim"],
                decoder_depth=cfg["decoder_depth"],
                decoder_num_heads=cfg["decoder_num_heads"],
                norm_pix_loss=cfg["norm_pix_loss"],
                mask_ratio=cfg["mask_ratio"],
                dtype=getattr(torch, cfg["compute_dtype"]), device=device)
    model.load_state_dict(weights, strict=True)
    o = cfg["optimizer"]
    optimizer = make_mae_optimizer(model, PretrainConfig(
        batch_size=traffic["batch"], weight_decay=o["weight_decay"]))
    schedule = make_schedule(o["base_lr"], o["warmup_steps"],
                             o["total_steps"])
    full_step = make_mae_full_step(schedule, cfg["img_size"])
    gen = inputs.generator(seed, inputs.STEP, "cpu")

    def step(i: int, batch: dict) -> torch.Tensor:
        return full_step(model, optimizer, batch["image"], gen,
                         o["first_step"] + i)["loss"]

    return types.SimpleNamespace(model=model, optimizer=optimizer, step=step)
