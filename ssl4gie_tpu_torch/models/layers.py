"""Transformer building blocks (port of `ssl4gie_tpu/models/layers.py`).

Parameters are float32 masters with timm names; `dtype` is the compute dtype.
Under bfloat16 each layer casts its weights to bfloat16 where it uses them, as
flax `dtype=bfloat16` does: LayerNorm statistics are taken in float32 (eps
1e-6) and the result cast back, GELU is the tanh form under bfloat16 and the
exact erf form under float32. Activations are NHWC images and (B, N, C) token
sequences, as in the JAX package.

Attention routes a (B, N, 3C) qkv with FUSED_MIN_SEQ <= N <= MAX_FUSED_SEQ to
`kernels.dense_attention.fused_qkv_attention` (the CUDA kernels on the card),
the same range as the JAX package's Pallas dispatch; other lengths take the
plain head-split attention, as there. The kernels take bfloat16 and 64-wide
heads: a float32 or other-width model on the card raises in that range
rather than silently taking the plain path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.kernels.dense_attention import (MAX_FUSED_SEQ,
                                                       fused_qkv_attention)

FUSED_MIN_SEQ = 160    # packed-QKV kernel range: dense tasks at N=197
TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding, (grid*grid [+1], embed_dim), float32.

    Behavioral match of MAE `util/pos_embed.py:get_2d_sincos_pos_embed` and MoCo v3's
    `build_2d_sincos_position_embedding` (both produce the same lattice; MAE orders
    [h-part, w-part] per token with sin/cos halves per axis).
    """
    assert embed_dim % 4 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)            # w varies fastest
    grid = np.stack(grid, axis=0).reshape(2, -1)  # (2, H*W): [w, h]

    def embed_1d(pos, dim):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = embed_1d(grid[1], embed_dim // 2)
    emb_w = embed_1d(grid[0], embed_dim // 2)
    pos = np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim), np.float32), pos], axis=0)
    return pos


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """flax `truncated_normal(std)`: N(0, 1) truncated to [-2, 2], scaled so
    the result has standard deviation `std` (inverse-CDF sampling)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    t.uniform_(lo, hi, generator=generator).erfinv_()
    return t.mul_(math.sqrt(2) * std / TRUNC_STD)


def init_linear(lin: nn.Linear, generator: torch.Generator,
                std: float = 0.02) -> None:
    """timm init: truncated-normal weight, zero bias."""
    trunc_normal_(lin.weight, std, generator)
    nn.init.zeros_(lin.bias)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight,
                        ln.bias, ln.eps).to(dtype)


def plain_attention(q, k, v, scale: float):
    """(q@k^T)*scale -> softmax (f32) -> @v in the input dtype, as the JAX
    package's `plain_attention`. q, k, v: (..., H, N, Dh)."""
    attn = (q @ k.transpose(-2, -1)) * scale
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(q.dtype)
    return attn @ v


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x):
        h = linear(x, self.fc1, self.dtype)
        # tanh GELU under bf16 compute, exact erf under f32 (JAX `Mlp`)
        approx = "tanh" if self.dtype == torch.bfloat16 else "none"
        return linear(F.gelu(h, approximate=approx), self.fc2, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C), non-windowed."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_linear(self.qkv, generator)
        init_linear(self.proj, generator)

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        Dh = C // H
        scale = Dh ** -0.5
        qkv = linear(x, self.qkv, self.dtype)
        if FUSED_MIN_SEQ <= N <= MAX_FUSED_SEQ:
            out = fused_qkv_attention(qkv, H, scale)
        else:
            t = qkv.reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
            out = plain_attention(t[0], t[1], t[2], scale)
            out = out.transpose(1, 2).reshape(B, N, C)
        return linear(out, self.proj, self.dtype)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm `DropPath`): per-sample
    Bernoulli keep with 1/keep rescaling. The mask is drawn on the
    generator's device."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class Block(nn.Module):
    """Pre-norm transformer block (timm layout: norm1/attn/norm2/mlp)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, drop_path_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in (self.norm1, self.norm2):
            ln.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, generator: torch.Generator | None = None):
        sd = self.drop_path_rate > 0 and self.training
        if sd and generator is None:
            raise ValueError("stochastic depth in training needs a generator")
        h = self.attn(layer_norm(x, self.norm1, self.dtype))
        if sd:
            h = drop_path(h, self.drop_path_rate, generator)
        x = x + h
        h = self.mlp(layer_norm(x, self.norm2, self.dtype))
        if sd:
            h = drop_path(h, self.drop_path_rate, generator)
        return x + h


class PatchEmbed(nn.Module):
    """Conv patchify (16x16 stride 16) of an NHWC image -> (B, N, C) tokens.
    xavier-uniform over the flattened (p*p*3, D) view, like the JAX package."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        D = self.proj.out_channels
        bound = math.sqrt(6.0 / (self.patch_size ** 2 * 3 + D))
        with torch.no_grad():
            self.proj.weight.uniform_(-bound, bound, generator=generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):  # (B, H, W, 3) NHWC
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     self.proj.weight.to(self.dtype),
                     self.proj.bias.to(self.dtype), stride=self.patch_size)
        B, C, gh, gw = x.shape
        return x.flatten(2).transpose(1, 2), (gh, gw)
