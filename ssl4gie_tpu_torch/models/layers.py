"""Transformer building blocks (port of `ssl4gie_tpu/models/layers.py`).

Parameters are float32 masters with timm names; `dtype` is the compute dtype.
Under bfloat16 each layer casts its weights to bfloat16 where it uses them, as
flax `dtype=bfloat16` does: LayerNorm statistics are taken in float32 (eps
1e-6) and the result cast back, GELU is the tanh form under bfloat16 and the
exact erf form under float32. Activations are NHWC images and (B, N, C) token
sequences, as in the JAX package.

Attention routes as the JAX package's Pallas dispatch does
(`ssl4gie_tpu/models/layers.py:289-357`), with the same ranges:
- a windowed block (ViTDet) -> `kernels.window_attention` on the
  (B, GH, GW, 3C) grid;
- no window, FUSED_MIN_SEQ <= N <= MAX_FUSED_SEQ -> the packed-QKV
  `kernels.dense_attention`;
- no window, N >= FLASH_MIN_SEQ with N % 256 == 0 (ViTDet's global blocks)
  -> `kernels.flash_attention` through `default_attention`;
- everything else -> plain head-split attention.
On a CPU tensor every kernel route runs its plain version; on the card it
launches the CUDA kernel of the compute dtype (bfloat16 on the tensor cores,
float32 on FFMAs). The kernels take 64-wide heads, the packed-QKV kernel
also 32- and 80-wide ones (every head width a JAX CLI configuration builds):
another width on the card raises in those ranges rather than silently
taking the plain path.

The MLP routes as the JAX package's `Mlp` does: with `SSL4GIE_FUSED_MLP=1`
in the environment (read once, into `FUSED_MLP`), a bfloat16 MLP over a
token count that is a multiple of 128 goes through `kernels.fused_mlp`
(tanh GELU); otherwise fc1 -> GELU -> fc2 as plain ops. The parameters are
`fc1`/`fc2` either way. Under tensor parallelism (`parallel/tp.py`) the
attention runs the same routes on each rank's heads and the MLP on its
slice of the hidden units, fused or not; `proj`'s and `fc2`'s biases are
added once, after the sum over the model group.

Linear layers take the timm init ("timm": truncated normal 0.02) or, for
MAE, flax's xavier_uniform ("xavier"), chosen by `kernel_init`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.kernels.dense_attention import (MAX_FUSED_SEQ,
                                                       fused_qkv_attention)
from ssl4gie_tpu_torch.kernels.flash_attention import flash_attention_heads
from ssl4gie_tpu_torch.kernels.fused_mlp import fused_mlp
from ssl4gie_tpu_torch.kernels.window_attention import windowed_flash_attention
from ssl4gie_tpu_torch.ops.resize import resize_bilinear_ac
from ssl4gie_tpu_torch.parallel.distributed import (copy_to_model,
                                                    rand_global,
                                                    reduce_from_model)

FUSED_MIN_SEQ = 160    # packed-QKV kernel range: dense tasks at N=197
FLASH_MIN_SEQ = 1024   # blockwise kernel for long sequences (detection)
TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]
KERNEL_INITS = ("timm", "xavier")
FUSED_MLP_TOKENS = 128   # the fused route's token multiple (JAX `Mlp`)
# opt-in fused fc1 + GELU + fc2 (`kernels.fused_mlp`), as the JAX package's
# `_FUSED_MLP`; a module global so that a caller can scope it
FUSED_MLP = os.environ.get("SSL4GIE_FUSED_MLP", "0") == "1"


def default_device(device=None) -> torch.device:
    """The device an entry point builds on: `device` when given, else the
    card. Without a card it raises (also when the card is asked for by
    name) rather than carry on on the CPU, which only an explicit
    `device="cpu"` asks for."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' (the CLIs: --device cpu) to run on "
                           "the CPU")
    return device


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


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid: int,
                          dst_grid: int) -> torch.Tensor:
    """Resize the grid part of a (1, 1 + N, D) position embedding (cls row
    first) bilinearly with align_corners=True, as the reference does for
    1024-px detection (14x14 -> 64x64) and the JAX package for a pooled
    image of another size than 224 px. (The reference's bicubic
    checkpoint-load variant is not what the JAX package runs.)"""
    d = pos_embed.shape[-1]
    grid = resize_bilinear_ac(pos_embed[:, 1:].reshape(1, src_grid, src_grid,
                                                       d), dst_grid, dst_grid)
    return torch.cat([pos_embed[:, :1], grid.reshape(1, dst_grid * dst_grid,
                                                     d)], dim=1)


@torch.no_grad()
def _trunc_standard_(t: torch.Tensor, generator: torch.Generator):
    """N(0, 1) truncated to [-2, 2], in place (inverse-CDF sampling)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    t.uniform_(lo, hi, generator=generator).erfinv_()
    return t.mul_(math.sqrt(2))


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """flax `truncated_normal(std)`: N(0, 1) truncated to [-2, 2], times
    `std`. `std` is the standard deviation of the untruncated distribution;
    the result's is `std * TRUNC_STD`."""
    return _trunc_standard_(t, generator).mul_(std)


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax `lecun_normal()` (the default kernel init of `nn.Dense`,
    `nn.Conv` and `nn.ConvTranspose`): the truncated draw times
    sqrt(1 / fan_in) / TRUNC_STD, so the result's standard deviation is
    sqrt(1 / fan_in)."""
    return _trunc_standard_(t, generator).mul_(math.sqrt(1.0 / fan_in)
                                               / TRUNC_STD)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator):
    """flax `xavier_uniform()`: U[-b, b] with b = sqrt(6 / (fan_in +
    fan_out)), in place."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)


def init_linear(lin: nn.Linear, generator: torch.Generator,
                kernel_init: str = "timm") -> None:
    """timm init (`TIMM_INIT`, truncated-normal(0.02) weight) or flax
    xavier-uniform ("xavier", MAE's `kernel_init`); zero bias."""
    if kernel_init == "xavier":
        xavier_uniform_(lin.weight, lin.in_features, lin.out_features,
                        generator)
    elif kernel_init == "timm":
        trunc_normal_(lin.weight, 0.02, generator)
    else:
        raise ValueError(f"kernel_init {kernel_init!r} not in {KERNEL_INITS}")
    nn.init.zeros_(lin.bias)


def init_lecun(mod: nn.Module, fan_in: int, generator: torch.Generator) -> None:
    """flax default init of a Dense/Conv/ConvTranspose: lecun-normal weight
    over `fan_in` inputs, zero bias."""
    lecun_normal_(mod.weight, fan_in, generator)
    nn.init.zeros_(mod.bias)


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


def default_attention(q, k, v, scale: float):
    """The flash kernel for long sequences (detection's 4,096 global tokens:
    N >= FLASH_MIN_SEQ, N % 256 == 0, (B, H, N, Dh)), plain otherwise."""
    n = q.shape[-2]
    if n >= FLASH_MIN_SEQ and n % 256 == 0 and q.ndim == 4:
        return flash_attention_heads(q, k, v, scale)
    return plain_attention(q, k, v, scale)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32,
                 kernel_init: str = "timm"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        # tensor parallelism (`parallel/tp.py`): the model group, whose
        # ranks hold fc1's rows and fc2's columns
        self.tp_group, self.tp_size = None, 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_linear(self.fc1, generator, self.kernel_init)
        init_linear(self.fc2, generator, self.kernel_init)

    def forward(self, x):
        tokens = x.numel() // x.shape[-1]
        fused = (FUSED_MLP and self.dtype == torch.bfloat16
                 and tokens % FUSED_MLP_TOKENS == 0)
        dt = self.dtype
        tp = self.tp_group is not None
        if tp:      # this rank's slice of the hidden units
            x = copy_to_model(x, self.tp_group)
        if fused:
            # the weights as (in, out) views, no copy; under TP fc2's bias
            # is added once, after the sum over the model group
            b2 = (self.fc2.bias.new_zeros(self.fc2.bias.shape, dtype=dt)
                  if tp else self.fc2.bias.to(dt))
            y = fused_mlp(x.to(dt), self.fc1.weight.to(dt).t(),
                          self.fc1.bias.to(dt), self.fc2.weight.to(dt).t(),
                          b2, True)
        else:
            h = linear(x, self.fc1, dt)
            # tanh GELU under bf16 compute, exact erf under f32 (JAX `Mlp`)
            g = F.gelu(h, approximate="tanh" if dt == torch.bfloat16
                       else "none")
            y = (F.linear(g, self.fc2.weight.to(dt)) if tp
                 else linear(g, self.fc2, dt))
        if tp:
            return reduce_from_model(y, self.tp_group) + self.fc2.bias.to(dt)
        return y


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C), optionally in
    non-overlapping `window_size` x `window_size` windows of the token grid
    (ViTDet), which then needs the grid shape `grid_hw`."""

    def __init__(self, dim: int, num_heads: int, window_size: int | None = None,
                 dtype=torch.float32, kernel_init: str = "timm"):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        # tensor parallelism (`parallel/tp.py`): the model group, whose
        # ranks hold their heads' rows of q, k and v and columns of proj
        self.tp_group, self.tp_size = None, 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_linear(self.qkv, generator, self.kernel_init)
        init_linear(self.proj, generator, self.kernel_init)

    def forward(self, x, grid_hw: tuple | None = None):
        B, N, D = x.shape
        Dh = D // self.num_heads
        scale = Dh ** -0.5
        # this rank's heads: all of them, or H / tp under TP, whose packed
        # [q_r | k_r | v_r] takes the same routes as the whole layer's
        H = self.num_heads // self.tp_size
        C = H * Dh
        if self.tp_group is not None:
            x = copy_to_model(x, self.tp_group)
        qkv = linear(x, self.qkv, self.dtype)
        if self.window_size is not None:
            gh, gw = grid_hw
            out = windowed_flash_attention(qkv.reshape(B, gh, gw, 3 * C), H,
                                           self.window_size, scale)
            out = out.reshape(B, N, C)
        elif FUSED_MIN_SEQ <= N <= MAX_FUSED_SEQ:
            out = fused_qkv_attention(qkv, H, scale)
        else:
            t = qkv.reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
            out = default_attention(t[0], t[1], t[2], scale)
            out = out.transpose(1, 2).reshape(B, N, C)
        if self.tp_group is not None:
            out = F.linear(out.to(self.dtype), self.proj.weight.to(self.dtype))
            return reduce_from_model(out, self.tp_group) + \
                self.proj.bias.to(self.dtype)
        return linear(out, self.proj, self.dtype)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm `DropPath`): per-sample
    Bernoulli keep with 1/keep rescaling. The mask is drawn on the
    generator's device, for the global batch when the batch is split over
    ranks (each keeps its rows)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = rand_global(shape, generator) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class Block(nn.Module):
    """Pre-norm transformer block (timm layout: norm1/attn/norm2/mlp)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, drop_path_rate: float = 0.0,
                 window_size: int | None = None, kernel_init: str = "timm"):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window_size, dtype=dtype,
                              kernel_init=kernel_init)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       kernel_init=kernel_init)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in (self.norm1, self.norm2):
            ln.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, generator: torch.Generator | None = None,
                grid_hw: tuple | None = None):
        sd = self.drop_path_rate > 0 and self.training
        if sd and generator is None:
            raise ValueError("stochastic depth in training needs a generator")
        h = self.attn(layer_norm(x, self.norm1, self.dtype), grid_hw)
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
