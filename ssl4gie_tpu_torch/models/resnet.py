"""ResNet-50 and the reference's dense depth decoder (port of
`ssl4gie_tpu/models/resnet.py`).

The body is torchvision's Bottleneck [3, 4, 6, 3] ResNet (v1.5: the stride
on the 3x3 convolution) with torchvision's state-dict names (`conv1`, `bn1`,
`layer1.0.conv2`, `layer1.0.downsample.0` / `.1`, ...), so that a
torchvision or MoCo state dict loads into it by name (its BatchNorms'
`num_batches_tracked` aside); the JAX package's top-level names
(`backbone.`, `encoder.`) and its decoder and head names are kept. At
output stride 16 every block of layer4 takes stride 1 and dilation 2, as
the JAX package's smp-style encoder does.

BatchNorm has flax semantics (`models/batchnorm.py`). Maps are NHWC; the
convolutions run in the compute dtype over float32 weights
(`models/vitdet_fpn.py:conv_nhwc`), and every spatial convolution pads
symmetrically (`padding = dilation * (k // 2)`: the JAX package's explicit
padding, and SAME for the 1x1 stride-2 shortcut, which is none). The
max-pool pads with -inf, as flax's `nn.max_pool` does.

Inits: the body's convolutions (no bias) are flax's `variance_scaling(2.0,
"fan_out", "normal")`, a plain normal of std sqrt(2 / (k * k * out)), as
torchvision's `kaiming_normal_(mode="fan_out")`; the decoder's
convolutions and `lin_head` keep flax's defaults, a truncated lecun normal
and a zero bias (`models/dpt.py:init_conv`).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.batchnorm import BatchNorm
from ssl4gie_tpu_torch.models.dpt import init_conv, upsample2x_ac
from ssl4gie_tpu_torch.models.layers import default_device, init_lecun
from ssl4gie_tpu_torch.models.vitdet_fpn import conv_nhwc

STAGE_SIZES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)    # bottleneck widths; a stage's output is 4x


def extent_mask(x: torch.Tensor, hw) -> torch.Tensor:
    """Zero an NHWC map beyond its valid extent `hw` = (h, w) (None: no
    mask). Applied before every spatial op, it makes the op's halo see the
    zeros that a tight canvas's padding gives, so in-extent activations
    equal a tight-canvas run (the detector's batch-max emulation)."""
    if hw is None:
        return x
    h, w = hw
    H, W = x.shape[1], x.shape[2]
    my = torch.arange(H, device=x.device) < h
    mx = torch.arange(W, device=x.device) < w
    return x * (my[:, None] & mx[None, :])[None, :, :, None].to(x.dtype)


@torch.no_grad()
def kaiming_normal_fan_out_(conv: nn.Conv2d,
                            generator: torch.Generator) -> None:
    """flax `variance_scaling(2.0, "fan_out", "normal")` on a torch
    (out, in, kh, kw) kernel: N(0, 2 / (out * kh * kw)), untruncated."""
    w = conv.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _half(hw):
    return None if hw is None else (hw[0] // 2, hw[1] // 2)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 to 4 x `width`, each with
    BatchNorm, plus the identity or a 1x1 strided projection
    (`downsample`)."""

    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm(width, dtype=dtype)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm(width, dtype=dtype)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = BatchNorm(4 * width, dtype=dtype)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, 4 * width, 1, stride=stride, bias=False),
                BatchNorm(4 * width, dtype=dtype))

    def forward(self, x, mask_hw=None):
        dt = self.dtype
        y = F.relu(self.bn1(conv_nhwc(x, self.conv1, dt)))
        y = extent_mask(y, mask_hw)     # conv2 is the block's only spatial op
        y = F.relu(self.bn2(conv_nhwc(y, self.conv2, dt,
                                      self.conv2.padding[0])))
        y = self.bn3(conv_nhwc(y, self.conv3, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv_nhwc(x, self.downsample[0],
                                                    dt))
        return F.relu(y + identity)


class ResNet50(nn.Module):
    """mode "pooled": (B, 2048), the mean of the last map; mode "dense":
    the four stage maps at strides 4, 8, 16, 32 (16 at output_stride 16).
    `stage_sizes` sets the blocks per stage (tests narrow it)."""

    def __init__(self, mode: str = "pooled", output_stride: int = 32,
                 dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES):
        super().__init__()
        if mode not in ("pooled", "dense"):
            raise ValueError(f"mode {mode!r} not in ('pooled', 'dense')")
        if output_stride not in (16, 32):
            raise ValueError(f"output_stride {output_stride} not in (16, 32)")
        self.mode, self.dtype = mode, dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, dtype=dtype)
        inplanes = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, WIDTHS)):
            dilate = stage == 3 and output_stride == 16
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0 and not dilate) else 1
                blocks.append(Bottleneck(inplanes, width, stride, b == 0,
                                         2 if dilate else 1, dtype))
                inplanes = 4 * width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fan_out_(m, generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x, mask_hw=None):
        """x: (B, H, W, 3) NHWC. mask_hw: an optional (h, w) valid extent at
        the input's resolution; the map beyond it is zeroed before every
        spatial op (`extent_mask`)."""
        x = extent_mask(x, mask_hw)
        x = F.relu(self.bn1(conv_nhwc(x, self.conv1, self.dtype, 3)))
        hw = _half(mask_hw)                 # stride 2 after the stem
        x = extent_mask(x, hw)
        # the -inf padding and the zeroed band agree on post-ReLU maps
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        hw = _half(hw)                      # stride 4
        taps = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, hw)
                if block.conv2.stride[0] == 2:
                    hw = _half(hw)
            taps.append(x)
        if self.mode == "dense":
            return taps
        return x.mean(dim=(1, 2))


class ResNetDecBlock(nn.Module):
    """The bottleneck decoder block (`ResNet_Dec_Block`): 1x1 to c/4, 3x3,
    1x1 to c, each with BatchNorm, plus the input or (fusion) its 1x1
    projection `id_conv` + `id_bn`."""

    def __init__(self, in_channels: int, channels: int, fusion: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.fusion, self.dtype = fusion, dtype
        c = channels
        if fusion:
            self.id_conv = nn.Conv2d(in_channels, c, 1)
            self.id_bn = BatchNorm(c, dtype=dtype)
        self.conv1 = nn.Conv2d(in_channels, c // 4, 1)
        self.bn1 = BatchNorm(c // 4, dtype=dtype)
        self.conv2 = nn.Conv2d(c // 4, c // 4, 3, padding=1)
        self.bn2 = BatchNorm(c // 4, dtype=dtype)
        self.conv3 = nn.Conv2d(c // 4, c, 1)
        self.bn3 = BatchNorm(c, dtype=dtype)

    def forward(self, x):
        dt = self.dtype
        identity = x
        if self.fusion:
            identity = self.id_bn(conv_nhwc(x, self.id_conv, dt))
        y = F.relu(self.bn1(conv_nhwc(x, self.conv1, dt)))
        y = F.relu(self.bn2(conv_nhwc(y, self.conv2, dt, 1)))
        y = self.bn3(conv_nhwc(y, self.conv3, dt))
        return F.relu(y + identity)


class ResNetDecLevel(nn.Module):
    """`ResNet_Dec_Level`: a 1x1 reduction with BatchNorm, the 2x
    align-corners upsample, the skip concatenated after it, then
    `n_blocks` decoder blocks (the first a fusion block)."""

    def __init__(self, low_channels: int, high_channels: int, channels: int,
                 n_blocks: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.reduce_conv = nn.Conv2d(low_channels, channels, 1)
        self.reduce_bn = BatchNorm(channels, dtype=dtype)
        for i in range(n_blocks):
            cin = channels + high_channels if i == 0 else channels
            self.add_module(f"block{i}", ResNetDecBlock(cin, channels, i == 0,
                                                        dtype))
        self.n_blocks = n_blocks

    def forward(self, x_low, x_high):
        x = self.reduce_bn(conv_nhwc(x_low, self.reduce_conv, self.dtype))
        x = torch.cat([upsample2x_ac(x), x_high], dim=-1)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def init_decoder(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default inits for every convolution and BatchNorm of a
    decoder or head."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            init_conv(m, generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()


class ResNetDepthModel(nn.Module):
    """ResNet-50 encoder (`encoder.`) + the reference's decoder (`level0`-
    `level2`, then 2x upsample, `out_conv1` 3x3 to 128, 2x upsample,
    `out_conv2` 3x3 to 32, ReLU, a float32 `out_conv3` 1x1 to 1) and a
    sigmoid: (B, H, W, 1) float32 in [0, 1].

    Weights are drawn from `generator` on the CPU (seed 0 when none is
    given), then moved to `device`: the card when none is given (no card
    raises; `device="cpu"` builds on the CPU)."""

    def __init__(self, dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = default_device(device)
        self.dtype = dtype
        self.encoder = ResNet50(mode="dense", dtype=dtype,
                                stage_sizes=stage_sizes)
        self.level0 = ResNetDecLevel(2048, 1024, 1024, dtype=dtype)
        self.level1 = ResNetDecLevel(1024, 512, 512, dtype=dtype)
        self.level2 = ResNetDecLevel(512, 256, 256, dtype=dtype)
        self.out_conv1 = nn.Conv2d(256, 128, 3, padding=1)
        self.out_conv2 = nn.Conv2d(128, 32, 3, padding=1)
        self.out_conv3 = nn.Conv2d(32, 1, 1)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.encoder.reset_parameters(gen)
        for m in (self.level0, self.level1, self.level2, self.out_conv1,
                  self.out_conv2, self.out_conv3):
            init_decoder(m, gen)
        self.to(device)

    def forward(self, x, generator: torch.Generator | None = None):
        """x: (B, H, W, 3) NHWC, H and W multiples of 32. `generator` is
        unused (the model draws nothing); the train step passes it."""
        dt = self.dtype
        taps: List[torch.Tensor] = self.encoder(x)
        out = self.level0(taps[3], taps[2])
        out = self.level1(out, taps[1])
        out = self.level2(out, taps[0])
        out = conv_nhwc(upsample2x_ac(out), self.out_conv1, dt, 1)
        out = F.relu(conv_nhwc(upsample2x_ac(out), self.out_conv2, dt, 1))
        out = conv_nhwc(out.to(torch.float32), self.out_conv3, torch.float32)
        return torch.sigmoid(out)


class ResNetClassifier(nn.Module):
    """ResNet-50 (`backbone.`) + the float32 linear head `lin_head` (2048 ->
    num_classes): float32 logits whatever the compute dtype. Weights and
    device as `ResNetDepthModel`'s."""

    def __init__(self, num_classes: int, dtype=torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = default_device(device)
        self.backbone = ResNet50(mode="pooled", dtype=dtype,
                                 stage_sizes=stage_sizes)
        self.lin_head = nn.Linear(4 * WIDTHS[-1], num_classes)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.backbone.reset_parameters(gen)
        init_lecun(self.lin_head, self.lin_head.in_features, gen)
        self.to(device)

    def forward(self, x, generator: torch.Generator | None = None):
        """x: (B, H, W, 3) NHWC; `generator` is unused (see
        `ResNetDepthModel.forward`)."""
        return self.lin_head(self.backbone(x).to(torch.float32))
