"""The ViTDet simple feature pyramid (port of `ssl4gie_tpu/models/vitdet_fpn.py`).

Four parallel branches off the final stride-16 ViT map give strides 32 / 16 /
8 / 4 by a 2x2 max-pool / identity / one 2x deconv / two 2x deconvs with
LayerNorm + exact GELU between; each is projected to 256 channels by a 1x1
conv, LayerNorm, a 3x3 conv and LayerNorm; a stride-2 subsample of the
stride-32 level adds stride 64. Output order [s4, s8, s16, s32, s64].
Activations are NHWC, as in the JAX package; the convolutions run in the
compute dtype over float32 weights.

ln_mode "channel" is the channel-wise LayerNorm (eps 1e-6); "chw" is the
reference's full-(C, H, W) LayerNorm (eps 1e-5, a per-element affine stored
(H, W, C)), which binds the model to one canvas, so it needs the ViT grid
`grid` at construction.

`ResNetFPN` is the RN50 detector's torchvision-style FPN over
`models/resnet.py:ResNet50`.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ssl4gie_tpu_torch.models.layers import init_lecun, layer_norm


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
              padding: int = 0) -> torch.Tensor:
    """An NHWC convolution with `conv`'s weights, stride, dilation and groups
    in `dtype` (a dense 1x1 one as a matmul over channels); `conv` may have
    no bias. The NCHW view of an NHWC map is channels-last, so cuDNN takes
    the map as it lies."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if w.shape[-2:] == (1, 1) and conv.stride == (1, 1) and conv.groups == 1:
        return F.linear(x.to(dtype), w[:, :, 0, 0], b)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, stride=conv.stride,
                 padding=padding, dilation=conv.dilation, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def deconv2x_nhwc(x: torch.Tensor, deconv: nn.ConvTranspose2d,
                  dtype: torch.dtype) -> torch.Tensor:
    """2x2 stride-2 transposed convolution of an NHWC map: out[2i + a] =
    w[a] . x[i] (torch's convention; the converter flips flax's kernel)."""
    y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                           deconv.weight.to(dtype), deconv.bias.to(dtype),
                           stride=2)
    return y.permute(0, 2, 3, 1)


class LayerNormCHW(nn.Module):
    """torch `nn.LayerNorm((C, H, W))` on NHWC input: statistics over all of
    (H, W, C) per sample, a per-element affine stored (H, W, C)."""

    def __init__(self, shape_hwc, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(shape_hwc))
        self.bias = nn.Parameter(torch.zeros(shape_hwc))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(1, 2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


def _norm(ln_mode: str, channels: int, hw: int | None, dtype):
    if ln_mode == "chw":
        return LayerNormCHW((hw, hw, channels), dtype=dtype)
    return nn.LayerNorm(channels, eps=1e-6)


class _Branch(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ln_mode: str,
                 hw: int | None, dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_channels, out_channels, 1)
        self.ln1 = _norm(ln_mode, out_channels, hw, dtype)
        self.conv = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.ln2 = _norm(ln_mode, out_channels, hw, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_lecun(self.proj, self.proj.in_channels, generator)
        init_lecun(self.conv, 9 * self.conv.in_channels, generator)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()

    def _ln(self, ln, x):
        return ln(x) if isinstance(ln, LayerNormCHW) else \
            layer_norm(x, ln, self.dtype)

    def forward(self, x):
        x = self._ln(self.ln1, conv_nhwc(x, self.proj, self.dtype))
        return self._ln(self.ln2, conv_nhwc(x, self.conv, self.dtype, 1))


class ViTDetFPN(nn.Module):
    def __init__(self, in_channels: int = 768, out_channels: int = 256,
                 dtype=torch.float32, ln_mode: str = "channel",
                 grid: int | None = None):
        super().__init__()
        if ln_mode not in ("channel", "chw"):
            raise ValueError(f"ln_mode {ln_mode!r}")
        if ln_mode == "chw" and grid is None:
            raise ValueError("ln_mode 'chw' needs the ViT grid size `grid`")
        self.dtype, self.ln_mode = dtype, ln_mode
        g = grid or 0
        c, o = in_channels, out_channels
        self.fpn1 = _Branch(c, o, ln_mode, g // 2, dtype)
        self.fpn2 = _Branch(c, o, ln_mode, g, dtype)
        self.fpn3_deconv = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.fpn3 = _Branch(c, o, ln_mode, 2 * g, dtype)
        self.fpn4_deconv1 = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.fpn4_ln = _norm(ln_mode, c, 2 * g, dtype)
        self.fpn4_deconv2 = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.fpn4 = _Branch(c, o, ln_mode, 4 * g, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for branch in (self.fpn1, self.fpn2, self.fpn3, self.fpn4):
            branch.reset_parameters(generator)
        for dc in (self.fpn3_deconv, self.fpn4_deconv1, self.fpn4_deconv2):
            init_lecun(dc, 4 * dc.in_channels, generator)
        self.fpn4_ln.reset_parameters()

    def forward(self, x) -> List[torch.Tensor]:
        """x: (B, H16, W16, C) final ViT map -> [s4, s8, s16, s32, s64]."""
        dt = self.dtype
        p32 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        p32 = self.fpn1(p32)
        p16 = self.fpn2(x)
        p8 = self.fpn3(deconv2x_nhwc(x, self.fpn3_deconv, dt))
        u4 = deconv2x_nhwc(x, self.fpn4_deconv1, dt)
        u4 = (self.fpn4_ln(u4) if self.ln_mode == "chw"
              else layer_norm(u4, self.fpn4_ln, dt))
        u4 = F.gelu(u4)                    # exact erf GELU, even under bf16
        p4 = self.fpn4(deconv2x_nhwc(u4, self.fpn4_deconv2, dt))
        p64 = p32[:, ::2, ::2]             # the 1x1 stride-2 max-pool
        return [p4, p8, p16, p32, p64]


class ResNetFPN(nn.Module):
    """The RN50 detector's backbone (`fasterrcnn_resnet50_fpn`): the
    ResNet-50 stage maps at strides 4-32 (`body`), 1x1 laterals
    (`fpn.inner_blocks.{i}`), a nearest 2x top-down sum from stride 32,
    3x3 output convolutions (`fpn.layer_blocks.{i}`) and a stride-64 level,
    the stride-2 1x1 max-pool of the stride-32 output. torchvision's
    state-dict names.

    The body's BatchNorms keep their running statistics in training too,
    as the JAX package runs its body with `train=False` (torchvision's
    `FrozenBatchNorm2d`); their scale and bias are parameters and train."""

    def __init__(self, out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        # imported here: models/resnet.py imports conv_nhwc from this module
        from ssl4gie_tpu_torch.models.resnet import WIDTHS, ResNet50
        self.dtype = dtype
        self.body = ResNet50(mode="dense", dtype=dtype)
        self.fpn = nn.Module()
        self.fpn.inner_blocks = nn.ModuleList(
            nn.Conv2d(4 * w, out_channels, 1) for w in WIDTHS)
        self.fpn.layer_blocks = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in WIDTHS)
        self.body.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.body.reset_parameters(generator)
        for conv in (*self.fpn.inner_blocks, *self.fpn.layer_blocks):
            kh, kw = conv.kernel_size
            init_lecun(conv, kh * kw * conv.in_channels, generator)

    def train(self, mode: bool = True):
        super().train(mode)
        self.body.eval()
        return self

    def forward(self, x, mask_hw=None) -> List[torch.Tensor]:
        """x: (B, H, W, 3) NHWC, H and W multiples of 32 -> [s4, s8, s16,
        s32, s64]. mask_hw: an optional (h, w) /32-multiple content extent
        at the input's resolution (the batch-max emulation,
        `resnet.extent_mask`): the body is masked before every spatial op,
        each level before its 3x3 output convolution, and the outputs after
        it, so the RPN's 3x3 convolution and RoIAlign's border taps read the
        zeros a tight canvas would give (the convolutions' biases otherwise
        fill the padded region)."""
        from ssl4gie_tpu_torch.models.resnet import extent_mask
        dt = self.dtype
        taps = self.body(x, mask_hw=mask_hw)
        lvl_hw = [None] * 4 if mask_hw is None else [
            (mask_hw[0] // s, mask_hw[1] // s) for s in (4, 8, 16, 32)]
        lat = [conv_nhwc(t, conv, dt)
               for t, conv in zip(taps, self.fpn.inner_blocks)]
        # top-down from stride 32; a coarse padded cell lands only on fine
        # padded cells, since the extents are exact halves
        outs = [lat[3]]
        for i in (2, 1, 0):
            B, h, w, C = outs[0].shape
            up = outs[0][:, :, None, :, None].expand(B, h, 2, w, 2, C)
            outs.insert(0, lat[i] + up.reshape(B, 2 * h, 2 * w, C))
        outs = [conv_nhwc(extent_mask(o, hw), conv, dt, 1)
                for o, hw, conv in zip(outs, lvl_hw, self.fpn.layer_blocks)]
        if mask_hw is not None:
            outs = [extent_mask(o, hw) for o, hw in zip(outs, lvl_hw)]
        return outs + [outs[3][:, ::2, ::2]]
