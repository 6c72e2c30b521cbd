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
`grid` at construction. `ResNetFPN` (the RN50 detector's FPN over
`models/resnet.py:ResNet50`) is not ported yet.
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
    """The RN50 FPN (over `models/resnet.py:ResNet50`) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ResNetFPN (the RN50 detector) is not "
                                  "ported yet")
