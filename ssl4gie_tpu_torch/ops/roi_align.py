"""RoIAlign (torchvision semantics) and FPN level assignment (port of
`ssl4gie_tpu/ops/roi_align.py:fpn_level_assignment, multiscale_roi_align`).

Aligned=False bilinear sampling with sampling_ratio 2 (2x2 points per output
bin), 7x7 output, and the FPN level mapper k = floor(4 + log2(sqrt(area) /
224)) clamped to the available levels. All levels of all images are
flattened into one (B * sum HW, C) table and each roi gathers its 4 * 14 * 14
bilinear taps from its level, batched over images. The gather indices come
from the same float operations in the same order as the JAX code, so they
are identical; the backward of the gather is a scatter-add (atomics on the
card, so its sums come in no fixed order there).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def fpn_level_assignment(rois: torch.Tensor, k_min: int = 2, k_max: int = 5,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """torchvision LevelMapper: k = floor(k0 + log2(sqrt(area)/s0 + eps)),
    returned as k - k_min (int32). rois: (..., 4)."""
    area = torch.clamp((rois[..., 2] - rois[..., 0]) *
                       (rois[..., 3] - rois[..., 1]), min=0.0)
    k = torch.floor(canonical_level +
                    torch.log2(torch.sqrt(area) / canonical_scale + 1e-6))
    return torch.clamp(k, k_min, k_max).to(torch.int32) - k_min


def multiscale_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         spatial_scales: Sequence[float], output_size: int = 7,
                         sampling_ratio: int = 2,
                         extent_hw: torch.Tensor | None = None) -> torch.Tensor:
    """features: list of (B, H_l, W_l, C) maps (strides 4..32); rois:
    (B, R, 4) in image coordinates. Returns (B, R, out, out, C).

    extent_hw: optional (L, 2) per-level (h, w) valid extents: the border
    clamp and outside rules apply at the extent instead of the map edge; the
    gather row stride stays the real map width."""
    L = len(features)
    B, R = rois.shape[:2]
    C = features[0].shape[-1]
    dev = rois.device
    levels = fpn_level_assignment(rois, k_min=2, k_max=2 + L - 1).long()

    hs = torch.tensor([f.shape[1] for f in features], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([f.shape[2] for f in features], dtype=torch.float32,
                      device=dev)
    scales = torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    bases = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                         dtype=torch.int32, device=dev)
    table = torch.cat([f.reshape(B, -1, C) for f in features], dim=1)
    T = table.shape[1]

    scale_r = scales[levels]                              # (B, R)
    if extent_hw is None:
        H_r, W_r = hs[levels], ws[levels]
    else:
        ext = torch.as_tensor(extent_hw, dtype=torch.float32, device=dev)
        H_r, W_r = ext[:, 0][levels], ext[:, 1][levels]
    W_row = ws[levels]
    base_r = bases[levels]

    x1 = rois[..., 0] * scale_r
    y1 = rois[..., 1] * scale_r
    x2 = rois[..., 2] * scale_r
    y2 = rois[..., 3] * scale_r
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    out, s = output_size, sampling_ratio
    P = out * s
    grid = (torch.arange(P, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[..., None] + grid * (roi_h / out)[..., None]          # (B, R, P)
    xs = x1[..., None] + grid * (roi_w / out)[..., None]
    yy = ys[..., :, None].expand(B, R, P, P)
    xx = xs[..., None, :].expand(B, R, P, P)

    Hc = H_r[..., None, None]
    Wc = W_r[..., None, None]
    outside = (yy < -1.0) | (yy > Hc) | (xx < -1.0) | (xx > Wc)
    y = torch.minimum(torch.clamp(yy, min=0.0), Hc - 1.0)
    x = torch.minimum(torch.clamp(xx, min=0.0), Wc - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1f = torch.minimum(y0 + 1, Hc - 1.0)
    x1f = torch.minimum(x0 + 1, Wc - 1.0)
    wy = y - y0
    wx = x - x0

    flat = table.reshape(B * T, C)
    img_base = (torch.arange(B, device=dev) * T)[:, None, None, None]
    base4 = base_r[..., None, None]
    wrow = W_row[..., None, None]

    def tap(yc, xc):
        lin = base4 + (yc * wrow + xc).to(torch.int32)
        return flat[(lin + img_base).reshape(-1)].reshape(B, R, P, P, C)

    v = (tap(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
         + tap(y0, x1f) * ((1 - wy) * wx)[..., None]
         + tap(y1f, x0) * (wy * (1 - wx))[..., None]
         + tap(y1f, x1f) * (wy * wx)[..., None])
    v = torch.where(outside[..., None], torch.zeros((), dtype=v.dtype,
                                                   device=dev), v)
    v = v.reshape(B, R, out, s, out, s, C)
    return v.mean(dim=(3, 5))
