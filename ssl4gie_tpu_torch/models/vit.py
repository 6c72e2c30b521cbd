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
  returned as a (B, GH, GW, C) map;
- mode "dense" (the DPT decoder's input), at 224 px: the token sequences
  (B, 1 + N, C), cls included and no final norm (the module has none),
  after blocks `dense_taps` (DENSE_TAPS, as the JAX field's default).
- stem "conv" (`ConvStem`, MoCo v3's `vit_conv_*`) in place of the 16 x 16
  patch projection, under the same name `patch_embed`; its BatchNorms
  follow the module's train/eval mode.
Other pooled or dense image sizes and the probe BatchNorm raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.dpt import init_conv
from ssl4gie_tpu_torch.models.layers import (Block, PatchEmbed,
                                             default_device,
                                             get_2d_sincos_pos_embed,
                                             init_lecun, interpolate_pos_embed,
                                             layer_norm, trunc_normal_)
from ssl4gie_tpu_torch.models.vitdet_fpn import conv_nhwc

BASE_GRID = 14         # position embedding stored at the pretraining grid
OUT_TOKENS = ("cls", "spatial", "global_pool")
DENSE_TAPS = (2, 5, 8, 11)           # dense mode: the DPT decoder's taps
GLOBAL_ATTN_BLOCKS = (2, 5, 8, 11)   # det mode: the rest are windowed
DET_WINDOW = 16


class ConvStem(nn.Module):
    """The 4-stage convolutional patchify of MoCo v3's `vit_conv_*`
    (`Models/moco_v3/vits.py:75-115`; port of
    `ssl4gie_tpu/models/layers.py:ConvStem`): four 3 x 3 stride-2
    convolutions without bias (`conv0`-`conv3`), each followed by a
    BatchNorm (`bn0`-`bn3`, flax semantics) and ReLU, with widths E/8, E/4,
    E/2, E, then a biased 1 x 1 projection `proj`. Total stride 16: the
    patch projection's token grid. Inits are flax's defaults."""

    def __init__(self, embed_dim: int = 768, dtype=torch.float32):
        super().__init__()
        if embed_dim % 8:
            raise ValueError(f"ConvStem needs embed_dim % 8 == 0, got "
                             f"{embed_dim}")
        self.dtype = dtype
        cin, d = 3, embed_dim // 8
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(cin, d, 3, stride=2,
                                                  padding=1, bias=False))
            self.add_module(f"bn{i}", BatchNorm(d, dtype=dtype))
            cin, d = d, 2 * d
        self.proj = nn.Conv2d(embed_dim, embed_dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(4):
            init_conv(getattr(self, f"conv{i}"), generator)
            getattr(self, f"bn{i}").reset_parameters()
        init_conv(self.proj, generator)

    def forward(self, x):  # (B, H, W, 3) NHWC
        for i in range(4):
            x = conv_nhwc(x, getattr(self, f"conv{i}"), self.dtype, 1)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        x = conv_nhwc(x, self.proj, self.dtype)
        B, gh, gw, C = x.shape
        return x.reshape(B, gh * gw, C), (gh, gw)


class ViTBackbone(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, mode: str = "pooled",
                 out_token: str = "cls", pos_embed_type: str = "learned",
                 stem: str = "patch", dtype=torch.float32,
                 drop_path_rate: float = 0.0,
                 dense_taps: tuple = DENSE_TAPS):
        super().__init__()
        if mode not in ("pooled", "dense", "det"):
            raise ValueError(f"mode {mode!r} not in ('pooled', 'dense', "
                             "'det')")
        det = mode == "det"
        if not det and img_size // patch_size != BASE_GRID:
            raise NotImplementedError(
                f"img_size {img_size}: only the {BASE_GRID}x{BASE_GRID} grid "
                "(224 px) is ported; position-embedding interpolation is not")
        if stem not in ("patch", "conv"):
            raise ValueError(f"stem {stem!r} not in ('patch', 'conv')")
        if out_token not in OUT_TOKENS:
            raise ValueError(f"out_token {out_token!r} not in {OUT_TOKENS}")
        if pos_embed_type not in ("learned", "sincos"):
            raise ValueError(f"pos_embed_type {pos_embed_type!r}")
        self.mode = mode
        self.dense_taps = tuple(dense_taps)
        self.out_token = out_token
        self.pos_embed_type = pos_embed_type
        self.dtype = dtype
        self.patch_embed = (ConvStem(embed_dim, dtype=dtype) if stem == "conv"
                            else PatchEmbed(patch_size, embed_dim,
                                            dtype=dtype))
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
        # (`Models/mae/models_vit.py:31`); dense mode has neither
        if mode != "dense":
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
        if self.mode != "dense":
            self.final_norm().reset_parameters()

    def final_norm(self) -> nn.LayerNorm:
        return self.fc_norm if hasattr(self, "fc_norm") else self.norm

    def forward(self, x, generator: torch.Generator | None = None):
        """x: (B, S, S, 3) NHWC -> pooled features (B, C), in det mode the
        normed (B, S/16, S/16, C) map, in dense mode the list of the
        `dense_taps` blocks' (B, 1 + N, C) outputs; in `dtype`."""
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
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, generator)
            if i in self.dense_taps:
                taps.append(x)
        if self.mode == "dense":
            return taps
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
    then moved to `device`: the card when none is given (no card raises;
    `device="cpu"` builds on the CPU)."""

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
        device = default_device(device)
        self.backbone = ViTBackbone(img_size=img_size, embed_dim=embed_dim,
                                    depth=depth, num_heads=num_heads,
                                    out_token=out_token,
                                    pos_embed_type=pos_embed_type, dtype=dtype,
                                    drop_path_rate=drop_path_rate)
        self.lin_head = nn.Linear(embed_dim, num_classes)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        # flax Dense default: lecun_normal (truncated, fan_in), zero bias
        init_lecun(self.lin_head, self.lin_head.in_features, generator)

    def forward(self, x, generator: torch.Generator | None = None):
        feat = self.backbone(x, generator).to(torch.float32)
        return self.lin_head(feat)
