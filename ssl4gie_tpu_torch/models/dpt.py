"""DPT (dense prediction transformer) decoder for ViT segmentation and depth
(port of `ssl4gie_tpu/models/dpt.py`).

readout 'ignore' (the cls token dropped), the four ViT taps reassembled to a
stride-4/8/16/32 pyramid (1x1 projections to `features`, then a 4x and a 2x
transposed convolution, identity, and a stride-2 3x3 convolution), 3x3
projections to the `fusion_features`-wide path, four FeatureFusionBlocks
(two ResidualConvUnits each, add-skip, 2x align-corners bilinear upsample,
1x1 out conv) and a head per task:
- seg: 3x3 conv (no bias), BatchNorm, ReLU, Dropout(0.1), a float32 1x1
  conv to `num_classes` logits, 2x upsample;
- depth: 3x3 conv, 2x upsample, 3x3 conv to 32, ReLU, a float32 1x1 conv
  to 1, sigmoid.
BatchNorm (flax semantics, `models/batchnorm.py`) sits inside the
ResidualConvUnits only for seg, whose convolutions then have no bias.

All maps are NHWC; the convolutions run in the compute dtype over float32
weights, as flax `dtype=` does. Module names are the JAX package's
(`proj1`, `resample1`, `layer1_rn`, `refinenet4.rcu1.conv1`, `head_bn`, ...).
The transposed convolutions follow torch's convention; the converter flips
flax's kernels (`convert/from_jax.py`).

The seg head's dropout mask is drawn from the caller's generator, on the
generator's device, or given as `dropout_mask` (a boolean keep mask of the
head's (B, H/2, W/2, fusion_features) activation), so that a test can hand
both packages one mask.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.layers import init_lecun, lecun_normal_
from ssl4gie_tpu_torch.models.vitdet_fpn import conv_nhwc
from ssl4gie_tpu_torch.ops.resize import resize_bilinear_ac
from ssl4gie_tpu_torch.parallel.distributed import rand_global

DROPOUT = 0.1


def upsample2x_ac(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NHWC map, align_corners=True."""
    return resize_bilinear_ac(x, x.shape[-3] * 2, x.shape[-2] * 2)


def deconv_nhwc(x: torch.Tensor, deconv: nn.ConvTranspose2d,
                dtype: torch.dtype) -> torch.Tensor:
    """k x k stride-k transposed convolution of an NHWC map (torch's
    convention: out[k i + a] = w[a] . x[i])."""
    y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                           deconv.weight.to(dtype), deconv.bias.to(dtype),
                           stride=deconv.stride)
    return y.permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def init_conv(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax `nn.Conv` default init: lecun-normal over kh * kw * cin, zero
    bias."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    if conv.bias is None:
        lecun_normal_(conv.weight, fan_in, generator)
    else:
        init_lecun(conv, fan_in, generator)


class ResidualConvUnit(nn.Module):
    """relu -> conv [-> bn] -> relu -> conv [-> bn], plus the input."""

    def __init__(self, features: int, use_bn: bool, dtype=torch.float32):
        super().__init__()
        self.use_bn, self.dtype = use_bn, dtype
        self.conv1 = _conv(features, features, 3, bias=not use_bn)
        self.conv2 = _conv(features, features, 3, bias=not use_bn)
        if use_bn:
            self.bn1 = BatchNorm(features, dtype=dtype)
            self.bn2 = BatchNorm(features, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_conv(self.conv1, generator)
        init_conv(self.conv2, generator)
        if self.use_bn:
            self.bn1.reset_parameters()
            self.bn2.reset_parameters()

    def forward(self, x):
        out = conv_nhwc(F.relu(x), self.conv1, self.dtype, 1)
        if self.use_bn:
            out = self.bn1(out)
        out = conv_nhwc(F.relu(out), self.conv2, self.dtype, 1)
        if self.use_bn:
            out = self.bn2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """[x + rcu1(skip)] -> rcu2 -> 2x upsample -> 1x1 out conv. Without a
    skip (the deepest block) there is no rcu1, as in flax."""

    def __init__(self, features: int, use_bn: bool, dtype=torch.float32,
                 with_skip: bool = True):
        super().__init__()
        self.dtype = dtype
        if with_skip:
            self.rcu1 = ResidualConvUnit(features, use_bn, dtype)
        self.rcu2 = ResidualConvUnit(features, use_bn, dtype)
        self.out_conv = _conv(features, features, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if hasattr(self, "rcu1"):
            self.rcu1.reset_parameters(generator)
        self.rcu2.reset_parameters(generator)
        init_conv(self.out_conv, generator)

    def forward(self, x, skip=None):
        out = x if skip is None else x + self.rcu1(skip)
        out = upsample2x_ac(self.rcu2(out))
        return conv_nhwc(out, self.out_conv, self.dtype)


class DPTDecoder(nn.Module):
    """The four ViT tap sequences [(B, 1 + N, vit_features)] -> seg logits
    (B, H, W, num_classes) in float32, or the depth map (B, H, W, 1) in
    [0, 1]."""

    def __init__(self, num_classes: int = 1, dense: str = "seg",
                 vit_features: int = 768,
                 features: Sequence[int] = (96, 192, 384, 768),
                 fusion_features: int = 256, dtype=torch.float32):
        super().__init__()
        if dense not in ("seg", "depth"):
            raise ValueError(f"dense {dense!r} not in ('seg', 'depth')")
        self.dense, self.dtype = dense, dtype
        self.vit_features = vit_features
        use_bn = dense == "seg"
        f, ff = list(features), fusion_features
        for i in range(4):
            self.add_module(f"proj{i + 1}", _conv(vit_features, f[i], 1))
        self.resample1 = nn.ConvTranspose2d(f[0], f[0], 4, stride=4)
        self.resample2 = nn.ConvTranspose2d(f[1], f[1], 2, stride=2)
        self.resample4 = _conv(f[3], f[3], 3, stride=2)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", _conv(f[i], ff, 3, bias=False))
        for i in (4, 3, 2, 1):
            self.add_module(f"refinenet{i}",
                            FeatureFusionBlock(ff, use_bn, dtype, i != 4))
        if dense == "depth":
            self.head_conv1 = _conv(ff, ff // 2, 3)
            self.head_conv2 = _conv(ff // 2, 32, 3)
            self.head_conv3 = _conv(32, 1, 1)
        else:
            self.head_conv1 = _conv(ff, ff, 3, bias=False)
            self.head_bn = BatchNorm(ff, dtype=dtype)
            self.head_conv2 = _conv(ff, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default inits, drawn in the order flax creates the
        layers."""
        for i in range(4):
            init_conv(getattr(self, f"proj{i + 1}"), generator)
            if i < 2:
                dc = getattr(self, f"resample{i + 1}")
                k = dc.kernel_size[0]
                init_lecun(dc, k * k * dc.in_channels, generator)
            elif i == 3:
                init_conv(self.resample4, generator)
            init_conv(getattr(self, f"layer{i + 1}_rn"), generator)
        for i in (4, 3, 2, 1):
            getattr(self, f"refinenet{i}").reset_parameters(generator)
        init_conv(self.head_conv1, generator)
        if self.dense == "depth":
            init_conv(self.head_conv2, generator)
            init_conv(self.head_conv3, generator)
        else:
            self.head_bn.reset_parameters()
            init_conv(self.head_conv2, generator)

    def reassemble(self, taps):
        """The taps -> the four fusion-width maps at strides 4, 8, 16, 32."""
        dt = self.dtype
        grid = int(round((taps[0].shape[1] - 1) ** 0.5))
        maps = []
        for i, t in enumerate(taps):
            m = t[:, 1:].reshape(t.shape[0], grid, grid, self.vit_features)
            m = conv_nhwc(m, getattr(self, f"proj{i + 1}"), dt)
            if i < 2:
                m = deconv_nhwc(m, getattr(self, f"resample{i + 1}"), dt)
            elif i == 3:
                m = conv_nhwc(m, self.resample4, dt, 1)
            maps.append(conv_nhwc(m, getattr(self, f"layer{i + 1}_rn"), dt, 1))
        return maps

    def forward(self, taps, generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        dt = self.dtype
        maps = self.reassemble(taps)
        path = self.refinenet4(maps[3])
        path = self.refinenet3(path, maps[2])
        path = self.refinenet2(path, maps[1])
        path = self.refinenet1(path, maps[0])
        if self.dense == "depth":
            out = upsample2x_ac(conv_nhwc(path, self.head_conv1, dt, 1))
            out = F.relu(conv_nhwc(out, self.head_conv2, dt, 1))
            out = conv_nhwc(out.to(torch.float32), self.head_conv3,
                            torch.float32)
            return torch.sigmoid(out)
        out = F.relu(self.head_bn(conv_nhwc(path, self.head_conv1, dt, 1)))
        if self.training:
            out = dropout(out, DROPOUT, generator, dropout_mask)
        out = conv_nhwc(out.to(torch.float32), self.head_conv2, torch.float32)
        return upsample2x_ac(out)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """flax `nn.Dropout`: x / (1 - rate) where `keep`, else 0. `keep` is
    drawn from `generator` (on its device; for the global batch when the
    batch is split over ranks, each keeping its rows) unless given."""
    if keep is None:
        if generator is None:
            raise ValueError("dropout in training needs a generator or a "
                             "mask")
        keep = rand_global(x.shape, generator) < 1.0 - rate
    keep = keep.to(x.device)
    if keep.shape != x.shape:
        raise ValueError(f"dropout mask {tuple(keep.shape)} != activation "
                         f"{tuple(x.shape)}")
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))
