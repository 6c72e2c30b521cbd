"""MAE (masked autoencoder) pretraining model (port of
`ssl4gie_tpu/ssl/mae.py`).

ViT encoder on the kept patches (25% at mask ratio 0.75, plus the cls
token), a 512-wide, 8-deep decoder with mask-token re-insertion and argsort
unshuffle, and the per-patch MSE on masked patches with optional per-patch
pixel normalization (unbiased variance, as torch's `.var()` in the
reference). Fixed 2-D sin-cos position embeddings for both halves are
buffers, not parameters. Every Linear of the blocks is initialised with
flax's xavier_uniform, the patch projection xavier over its flattened view,
`cls_token` and `mask_token` N(0, 0.02) with their (1, 1, C) shapes, and
`decoder_embed`/`decoder_pred` flax's default lecun-normal.

Module names follow the encoder of `ViTBackbone` (`patch_embed.proj`,
`cls_token`, `blocks.{i}....`, `norm`) beside `decoder_embed`,
`mask_token`, `decoder_blocks.{i}....`, `decoder_norm`, `decoder_pred`.

Randomness is injected: `forward(imgs, noise)` takes the (B, L) uniform
noise whose argsort picks the kept patches (`draw_noise` draws it from a
`torch.Generator`). The JAX package's one-hot permutation matmul
(`_permute_tokens`) is a TPU stand-in for a gather; here it is
`torch.gather`, which gives the same tokens.

Compute dtype as the JAX package: the encoder and decoder run in `dtype`,
LayerNorm statistics in float32, `decoder_pred` and the loss in float32.
`remat=True` recomputes each block's activations in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX package's `nn.remat`
on the encoder's and the decoder's blocks): a memory lever for vit_l and
vit_h, whose kernels then launch their forwards twice.

Attention routes as `models/layers.py` does: the encoder's 50 tokens take
the plain path (N < 160), the decoder's 197 tokens the packed-QKV kernel at
Dh = 32 (512 / 16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssl4gie_tpu_torch.models.layers import (Block, PatchEmbed,
                                             default_device,
                                             get_2d_sincos_pos_embed,
                                             init_lecun, layer_norm)


def patchify(imgs: torch.Tensor, p: int = 16) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, L, p*p*3), token pixel order p-row, p-col,
    channel (`models_mae.patchify`)."""
    B, H, W, C = imgs.shape
    h, w = H // p, W // p
    x = imgs.reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * w, p * p * C)


def unpatchify(x: torch.Tensor, p: int = 16) -> torch.Tensor:
    B, L, D = x.shape
    h = w = int(L ** 0.5)
    C = D // (p * p)
    x = x.reshape(B, h, w, p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * p, w * p, C)


def random_masking(x: torch.Tensor, mask_ratio: float, noise: torch.Tensor):
    """Per-sample shuffle by a stable argsort of `noise` (B, L)
    (`models_mae.py:123-148`; `jnp.argsort` is stable). Returns (x_masked
    (B, len_keep, D), mask (B, L) in x's dtype with 0 = keep and 1 =
    removed, ids_restore (B, L))."""
    B, L, D = x.shape
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[..., None].expand(B, len_keep, D))
    mask = torch.ones((B, L), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


# Size presets of the reference factories (`Models/mae/models_mae.py:
# 223-250`: mae_vit_{base,large,huge}_patch{16,16,14}_dec512d8b). All share
# the 512-wide / 8-deep / 16-head decoder. SSL4GIE's recipe uses vit_b.
MAE_SIZES = {
    "vit_b": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "vit_l": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
    "vit_h": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16),
}


class MAE(nn.Module):
    """Encoder + decoder; `forward` returns (loss, pred, mask).

    Weights are drawn from `generator` on the CPU (seed 0 when none is
    given), then moved to `device`: the card when none is given (no card
    raises; `device="cpu"` builds on the CPU)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = True, mask_ratio: float = 0.75,
                 dtype=torch.float32, remat: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = default_device(device)
        self.img_size, self.patch_size = img_size, patch_size
        self.norm_pix_loss = norm_pix_loss
        self.remat = remat
        self.mask_ratio = mask_ratio
        self.dtype = dtype
        grid = img_size // patch_size
        self.num_patches = grid * grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype=dtype,
                  kernel_init="xavier") for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, dtype=dtype,
                  kernel_init="xavier") for _ in range(decoder_depth))
        self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=1e-6)
        self.decoder_pred = nn.Linear(decoder_embed_dim,
                                      patch_size ** 2 * 3)
        # fixed, not learned: buffers outside the state_dict
        for name, dim in (("pos_embed", embed_dim),
                          ("decoder_pos_embed", decoder_embed_dim)):
            self.register_buffer(name, torch.from_numpy(
                get_2d_sincos_pos_embed(dim, grid, cls_token=True))[None],
                persistent=False)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        for t in (self.cls_token, self.mask_token):
            t.normal_(0.0, 0.02, generator=generator)
        for blk in (*self.blocks, *self.decoder_blocks):
            blk.reset_parameters(generator)
        for ln in (self.norm, self.decoder_norm):
            ln.reset_parameters()
        for lin in (self.decoder_embed, self.decoder_pred):
            init_lecun(lin, lin.in_features, generator)

    def _block(self, blk: Block, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False)
        return blk(x)

    def draw_noise(self, batch: int, generator: torch.Generator):
        """The masking noise U[0, 1) (B, L) on the generator's device."""
        return torch.rand((batch, self.num_patches), generator=generator,
                          device=generator.device)

    def forward(self, imgs: torch.Tensor, noise: torch.Tensor):
        """imgs: (B, S, S, 3) normalized NHWC, noise: (B, L) masking noise.
        Returns (loss (float32 scalar), pred (B, L, p*p*3) float32, mask
        (B, L) in `dtype`)."""
        dt = self.dtype
        x, _ = self.patch_embed(imgs)
        x = x + self.pos_embed[:, 1:].to(dt)
        x, mask, ids_restore = random_masking(x, self.mask_ratio,
                                              noise.to(x.device))
        B, _, C = x.shape
        cls = (self.cls_token + self.pos_embed[:, :1]).to(dt)
        x = torch.cat([cls.expand(B, 1, C), x], dim=1)
        for blk in self.blocks:
            x = self._block(blk, x)
        latent = layer_norm(x, self.norm, dt)

        # decoder (`forward_decoder`, models_mae.py:172-196)
        y = F.linear(latent, self.decoder_embed.weight.to(dt),
                     self.decoder_embed.bias.to(dt))
        D = y.shape[-1]
        L = self.num_patches
        mask_tokens = self.mask_token.to(dt).expand(B, L + 1 - y.shape[1], D)
        y_ = torch.cat([y[:, 1:], mask_tokens], dim=1)
        y_ = torch.gather(y_, 1, ids_restore[..., None].expand(B, L, D))
        y = torch.cat([y[:, :1], y_], dim=1) + self.decoder_pos_embed.to(dt)
        for blk in self.decoder_blocks:
            y = self._block(blk, y)
        y = layer_norm(y, self.decoder_norm, dt)
        pred = F.linear(y.float(), self.decoder_pred.weight,
                        self.decoder_pred.bias)[:, 1:]

        # loss (`forward_loss`, models_mae.py:198-214)
        target = patchify(imgs.float(), self.patch_size)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=True)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred - target) ** 2).mean(dim=-1)
        mask_f = mask.float()
        return (loss * mask_f).sum() / mask_f.sum(), pred, mask
