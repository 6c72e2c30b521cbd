"""The plain reference of `mae_vitb16`: `models_mae.py`'s MaskedAutoencoderViT
(`mae_vit_base_patch16_dec512d8b`) in float32 — patch embedding, fixed
2-D sin-cos position tables, per-sample masking by a stable argsort of the
noise, the encoder over the kept patches and cls, decoder_embed, mask
tokens, the unshuffle, the decoder, decoder_pred, and the per-patch MSE on
the masked patches against the pixel-normalized target (unbiased
variance, eps 1e-6) — with the MAE augmentation of `reference/augment.py`,
AdamW decaying the leaves of more than one dimension (timm's
`add_weight_decay`), and the recipe's warm-up then cosine rate.

Imports nothing of the program. Departure noted: the position tables put
the row coordinate in the first half of each row and the column in the
second, as the port and the JAX package build them; `util/pos_embed.py`
could not be read here to confirm the order it uses.
"""

from __future__ import annotations

import math

import torch

from portbench import inputs
from portbench.reference import augment, plain


def rate(o: dict, step: int) -> float:
    """Linear from 0 over the warm-up, then cosine to 0 at the end."""
    warmup = max(o["warmup_steps"], 1)
    if step < warmup:
        return o["base_lr"] * step / warmup
    decay = max(o["total_steps"], o["warmup_steps"] + 1) - warmup
    t = min(step - warmup, decay)
    return o["base_lr"] * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def loss_fn(cfg: dict, precision: str, device):
    P, grid = cfg["patch_size"], cfg["img_size"] // cfg["patch_size"]
    L = grid * grid
    keep = int(L * (1 - cfg["mask_ratio"]))
    pos = plain.sincos_2d(cfg["embed_dim"], grid).to(device)[None]
    dec_pos = plain.sincos_2d(cfg["decoder_embed_dim"], grid).to(device)[None]

    def loss(w: dict, batch: dict) -> torch.Tensor:
        imgs, noise = batch["image"], batch["noise"]
        x = plain.patch_embed(imgs, w["patch_embed.proj.weight"],
                              w["patch_embed.proj.bias"], P, precision)
        x = x + pos[:, 1:]
        B, _, D = x.shape
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        x = torch.gather(x, 1, ids_shuffle[:, :keep, None].expand(B, keep, D))
        mask = torch.ones(B, L, device=device)
        mask[:, :keep] = 0
        mask = torch.gather(mask, 1, ids_restore)
        cls = (w["cls_token"] + pos[:, :1]).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        for i in range(cfg["depth"]):
            x = plain.block(x, w, f"blocks.{i}", cfg["num_heads"], precision)
        x = plain.layer_norm(x, w, "norm")
        y = plain.linear(x, w["decoder_embed.weight"], w["decoder_embed.bias"],
                         precision)
        E = y.shape[-1]
        y_ = torch.cat([y[:, 1:], w["mask_token"].expand(B, L - keep, E)],
                       dim=1)
        y_ = torch.gather(y_, 1, ids_restore[..., None].expand(B, L, E))
        y = torch.cat([y[:, :1], y_], dim=1) + dec_pos
        for i in range(cfg["decoder_depth"]):
            y = plain.block(y, w, f"decoder_blocks.{i}",
                            cfg["decoder_num_heads"], precision)
        y = plain.layer_norm(y, w, "decoder_norm")
        # decoder_pred and the loss compute in float32 in the program too
        pred = plain.linear(y, w["decoder_pred.weight"], w["decoder_pred.bias"],
                            "float32")[:, 1:]
        target = imgs.reshape(B, grid, P, grid, P, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(B, L, P * P * 3)
        if cfg["norm_pix_loss"]:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=True)
            target = (target - mean) / (var + 1e-6) ** 0.5
        per_patch = ((pred - target) ** 2).mean(dim=-1)
        return (per_patch * mask).sum() / mask.sum()

    return loss


def readings(cfg: dict, traffic: dict, data: dict, weights: dict, seed: int,
             steps: int, precision: str = "float32") -> dict:
    """The first `steps` steps from `weights` on the pool's first batches,
    with the step's crop, flip and masking draws replayed from `seed`."""
    gen = inputs.generator(seed, inputs.STEP, "cpu")
    o = cfg["optimizer"]
    params = {n: p.detach().clone() for n, p in weights.items()}
    opt = plain.AdamW(params, o["b1"], o["b2"], o["eps"], o["weight_decay"],
                      decay=lambda name, p: p.dim() > 1)
    device = next(iter(weights.values())).device
    L = (cfg["img_size"] // cfg["patch_size"]) ** 2
    with plain.no_tf32():
        batches = []
        for i in range(steps):
            img = data["batches"][i % len(data["batches"])]["image"]
            draws = augment.draw_mae(img.shape[0], gen, L)
            batches.append({"image": augment.mae(img, draws, cfg["img_size"],
                                                 plain.rounding(precision)),
                            "noise": draws["noise"].to(device)})
        return plain.train_readings(
            params, loss_fn(cfg, precision, device), batches,
            [rate(o, o["first_step"] + i) for i in range(steps)], opt)
