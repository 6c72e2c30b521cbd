"""ViT-B/16 backbone in pooled and det modes and the linear classifier (port
of `ssl4gie_tpu/models/vit.py`).

Parameter names follow timm (`patch_embed.proj`, `cls_token`, `pos_embed`,
`blocks.{i}.norm1/.attn.qkv/.attn.proj/.norm2/.mlp.fc1/.mlp.fc2`, `norm` or
`fc_norm`), so reference checkpoints load with `load_state_dict`; the
classifier puts them under `backbone.` beside `lin_head`.

Ported so far:
- mode "pooled" with out_token cls | spatial | global_pool and
  pos_embed_type learned | sincos, at 224 px (the 14x14 + cls position grid
  the embedding is stored at);
- mode "det" (ViTDet, any img_size that is a multiple of 16 * DET_WINDOW):
  no cls token and no `cls_token` parameter; the 14x14 position grid is
  interpolated bilinearly to the patch grid and its cls row dropped; blocks
  GLOBAL_ATTN_BLOCKS attend globally and the others in DET_WINDOW x
  DET_WINDOW windows; the final norm is applied, then the tokens are
  returned as a (B, GH, GW, C) map.
Mode "dense", other pooled image sizes, the conv stem and the probe
BatchNorm raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ssl4gie_tpu_torch.models.layers import (Block, PatchEmbed,
                                             get_2d_sincos_pos_embed,
                                             init_lecun, interpolate_pos_embed,
                                             layer_norm, trunc_normal_)

BASE_GRID = 14         # position embedding stored at the pretraining grid
OUT_TOKENS = ("cls", "spatial", "global_pool")
GLOBAL_ATTN_BLOCKS = (2, 5, 8, 11)   # det mode: the rest are windowed
DET_WINDOW = 16


class ViTBackbone(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, mode: str = "pooled",
                 out_token: str = "cls", pos_embed_type: str = "learned",
                 stem: str = "patch", dtype=torch.float32,
                 drop_path_rate: float = 0.0):
        super().__init__()
        if mode not in ("pooled", "det"):
            raise NotImplementedError(f"mode {mode!r}: only 'pooled' and "
                                      "'det' are ported")
        det = mode == "det"
        if not det and img_size // patch_size != BASE_GRID:
            raise NotImplementedError(
                f"img_size {img_size}: only the {BASE_GRID}x{BASE_GRID} grid "
                "(224 px) is ported; position-embedding interpolation is not")
        if stem != "patch":
            raise NotImplementedError(f"stem {stem!r}: only 'patch' is ported")
        if out_token not in OUT_TOKENS:
            raise ValueError(f"out_token {out_token!r} not in {OUT_TOKENS}")
        if pos_embed_type not in ("learned", "sincos"):
            raise ValueError(f"pos_embed_type {pos_embed_type!r}")
        self.mode = mode
        self.out_token = out_token
        self.pos_embed_type = pos_embed_type
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        if not det:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, BASE_GRID * BASE_GRID + 1, embed_dim))
        # stochastic depth rates linspace(0, rate, depth), as timm
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype=dtype,
                  drop_path_rate=drop_path_rate * i / max(depth - 1, 1),
                  window_size=(DET_WINDOW if det and i not in
                               GLOBAL_ATTN_BLOCKS else None))
            for i in range(depth))
        # the global_pool recipe has fc_norm and no final norm
        # (`Models/mae/models_vit.py:31`)
        norm_name = ("fc_norm" if out_token == "global_pool" and not det
                     else "norm")
        self.add_module(norm_name, nn.LayerNorm(embed_dim, eps=1e-6))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        if self.mode != "det":
            nn.init.zeros_(self.cls_token)
        with torch.no_grad():
            if self.pos_embed_type == "sincos":
                self.pos_embed.copy_(torch.from_numpy(get_2d_sincos_pos_embed(
                    self.pos_embed.shape[-1], BASE_GRID, cls_token=True))[None])
            else:
                trunc_normal_(self.pos_embed, 0.02, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm().reset_parameters()

    def final_norm(self) -> nn.LayerNorm:
        return self.fc_norm if hasattr(self, "fc_norm") else self.norm

    def forward(self, x, generator: torch.Generator | None = None):
        """x: (B, S, S, 3) NHWC -> pooled features (B, C), or in det mode
        the normed (B, S/16, S/16, C) map, in `dtype`."""
        x, (gh, gw) = self.patch_embed(x)
        B, N, C = x.shape
        if self.mode == "det":
            pe = interpolate_pos_embed(self.pos_embed.to(torch.float32),
                                       BASE_GRID, gh)
            x = x + pe[:, 1:].to(self.dtype)    # cls row dropped
            for blk in self.blocks:
                x = blk(x, generator, (gh, gw))
            x = layer_norm(x, self.norm, self.dtype)
            return x.reshape(B, gh, gw, C)
        cls = self.cls_token.to(self.dtype).expand(B, 1, C)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        if self.out_token == "global_pool":
            # pre-norm patch-token mean, then fc_norm
            return layer_norm(x[:, 1:].mean(dim=1), self.fc_norm, self.dtype)
        x = layer_norm(x, self.norm, self.dtype)
        if self.out_token == "spatial":
            return x[:, 1:].mean(dim=1)
        return x[:, 0]


class ViTClassifier(nn.Module):
    """ViT backbone + linear head `lin_head`. The pooled feature, the head and
    the logits are float32 whatever the compute dtype.

    Weights are drawn from `generator` on the CPU (seed 0 when none is given),
    then moved to `device`."""

    def __init__(self, num_classes: int, out_token: str = "cls",
                 pos_embed_type: str = "learned", img_size: int = 224,
                 dtype=torch.float32, probe_bn: bool = False,
                 drop_path_rate: float = 0.0, depth: int = 12,
                 embed_dim: int = 768, num_heads: int = 12,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if probe_bn:
            raise NotImplementedError("probe_bn (linear-probe BatchNorm) is "
                                      "not ported")
        self.backbone = ViTBackbone(img_size=img_size, embed_dim=embed_dim,
                                    depth=depth, num_heads=num_heads,
                                    out_token=out_token,
                                    pos_embed_type=pos_embed_type, dtype=dtype,
                                    drop_path_rate=drop_path_rate)
        self.lin_head = nn.Linear(embed_dim, num_classes)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        # flax Dense default: lecun_normal (truncated, fan_in), zero bias
        init_lecun(self.lin_head, self.lin_head.in_features, generator)

    def forward(self, x, generator: torch.Generator | None = None):
        feat = self.backbone(x, generator).to(torch.float32)
        return self.lin_head(feat)
