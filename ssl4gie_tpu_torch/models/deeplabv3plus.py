"""DeepLabV3+ with a ResNet-50 encoder (port of
`ssl4gie_tpu/models/deeplabv3plus.py`, the smp model the reference trains
for RN50 segmentation).

The encoder runs at output stride 16 (layer4 dilated); the ASPP takes its
last map through a 1x1 branch, three separable 3x3 branches at rates 12,
24, 36 and an image-pooling branch (its BatchNorm takes statistics over the
batch's B pooled values per channel), a 1x1 projection and Dropout(0.5);
then a separable 3x3, a 4x align-corners resize, the 48-channel 1x1
projection of layer1 concatenated after it, a separable 3x3 fuse, and a
float32 3x3 head whose logits are resized 4x to the input's size.

Names are the JAX package's (`encoder.`, `aspp.b1_conv.depthwise`,
`aspp_post_bn`, `high_conv`, `fuse_conv.pointwise`, `seg_head`, ...), the
encoder's own torchvision's (`models/resnet.py`). A depthwise kernel is
torch's (C, 1, kh, kw), flax's (kh, kw, 1, C). The decoder keeps flax's
default inits (truncated lecun normal, zero bias).

The ASPP's dropout mask is drawn from the caller's generator, on the
generator's device, or given as `dropout_mask` (a boolean keep mask of the
ASPP's (B, H/16, W/16, 256) output), as the DPT seg head's is
(`models/dpt.py`), so that a test can hand both packages one mask.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.dpt import dropout
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.models.resnet import (STAGE_SIZES, ResNet50,
                                             init_decoder)
from ssl4gie_tpu_torch.models.vitdet_fpn import conv_nhwc
from ssl4gie_tpu_torch.ops.resize import resize_bilinear_ac

DROPOUT = 0.5
RATES = (12, 24, 36)


class SeparableConv(nn.Module):
    """A depthwise k x k convolution (dilated, no bias) then a pointwise
    1x1 to `features`."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dilation: int = 1, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pad = (kernel // 2) * dilation
        self.depthwise = nn.Conv2d(in_channels, in_channels, kernel,
                                   padding=self.pad, dilation=dilation,
                                   groups=in_channels, bias=False)
        self.pointwise = nn.Conv2d(in_channels, features, 1, bias=use_bias)

    def forward(self, x):
        x = conv_nhwc(x, self.depthwise, self.dtype, self.pad)
        return conv_nhwc(x, self.pointwise, self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling, smp's separable variant."""

    def __init__(self, in_channels: int = 2048, features: int = 256,
                 rates: Sequence[int] = RATES, dtype=torch.float32):
        super().__init__()
        self.dtype, self.n_rates = dtype, len(rates)
        self.b0_conv = nn.Conv2d(in_channels, features, 1, bias=False)
        self.b0_bn = BatchNorm(features, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"b{i + 1}_conv", SeparableConv(
                in_channels, features, 3, dilation=r, dtype=dtype))
            self.add_module(f"b{i + 1}_bn", BatchNorm(features, dtype=dtype))
        self.pool_conv = nn.Conv2d(in_channels, features, 1, bias=False)
        self.pool_bn = BatchNorm(features, dtype=dtype)
        self.project_conv = nn.Conv2d((len(rates) + 2) * features, features,
                                      1, bias=False)
        self.project_bn = BatchNorm(features, dtype=dtype)

    def forward(self, x, generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        dt = self.dtype
        branches = [F.relu(self.b0_bn(conv_nhwc(x, self.b0_conv, dt)))]
        for i in range(1, self.n_rates + 1):
            b = getattr(self, f"b{i}_conv")(x)
            branches.append(F.relu(getattr(self, f"b{i}_bn")(b)))
        # image pooling: global mean -> 1x1 -> broadcast back
        pooled = conv_nhwc(x.mean(dim=(1, 2), keepdim=True), self.pool_conv,
                           dt)
        pooled = F.relu(self.pool_bn(pooled))
        branches.append(pooled.expand(branches[0].shape))
        y = conv_nhwc(torch.cat(branches, dim=-1), self.project_conv, dt)
        y = F.relu(self.project_bn(y))
        if self.training:
            y = dropout(y, DROPOUT, generator, dropout_mask)
        return y


class DeepLabV3Plus(nn.Module):
    """(B, H, W, 3) NHWC, H and W multiples of 16 -> float32 logits (B, H,
    W, num_classes).

    Weights are drawn from `generator` on the CPU (seed 0 when none is
    given), then moved to `device`: the card when none is given (no card
    raises; `device="cpu"` builds on the CPU). `stage_sizes` narrows the
    encoder (tests)."""

    def __init__(self, num_classes: int = 1, decoder_channels: int = 256,
                 highres_channels: int = 48, dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = default_device(device)
        self.dtype = dtype
        dc = decoder_channels
        self.encoder = ResNet50(mode="dense", output_stride=16, dtype=dtype,
                                stage_sizes=stage_sizes)
        self.aspp = ASPP(2048, dc, dtype=dtype)
        self.aspp_post = SeparableConv(dc, dc, 3, dtype=dtype)
        self.aspp_post_bn = BatchNorm(dc, dtype=dtype)
        self.high_conv = nn.Conv2d(256, highres_channels, 1, bias=False)
        self.high_bn = BatchNorm(highres_channels, dtype=dtype)
        self.fuse_conv = SeparableConv(dc + highres_channels, dc, 3,
                                       dtype=dtype)
        self.fuse_bn = BatchNorm(dc, dtype=dtype)
        self.seg_head = nn.Conv2d(dc, num_classes, 3, padding=1)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.encoder.reset_parameters(gen)
        for m in (self.aspp, self.aspp_post, self.aspp_post_bn,
                  self.high_conv, self.high_bn, self.fuse_conv, self.fuse_bn,
                  self.seg_head):
            init_decoder(m, gen)
        self.to(device)

    def forward(self, x, generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """In train mode `generator` draws the ASPP's dropout mask (or
        `dropout_mask` is that mask)."""
        dt = self.dtype
        taps = self.encoder(x)      # layer1 (stride 4) ... layer4 (stride 16)
        y = self.aspp(taps[3], generator, dropout_mask)
        y = F.relu(self.aspp_post_bn(self.aspp_post(y)))
        y = resize_bilinear_ac(y, y.shape[1] * 4, y.shape[2] * 4)
        high = F.relu(self.high_bn(conv_nhwc(taps[0], self.high_conv, dt)))
        y = F.relu(self.fuse_bn(self.fuse_conv(torch.cat([y, high], dim=-1))))
        y = conv_nhwc(y.to(torch.float32), self.seg_head, torch.float32, 1)
        return resize_bilinear_ac(y, y.shape[1] * 4, y.shape[2] * 4)
