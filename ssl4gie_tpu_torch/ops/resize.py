"""Bilinear resize with align_corners=True (port of `ssl4gie_tpu/ops/resize.py`).

The JAX package builds the interpolation as two static matmuls for the TPU's
matrix unit; here it is `F.interpolate(mode="bilinear", align_corners=True)`
in float32, the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize a (..., H, W, C) tensor (H, W at dims -3, -2) with
    align_corners=True bilinear interpolation, computed in float32 and
    returned in the input dtype."""
    *lead, h, w, c = x.shape
    if (out_h, out_w) == (h, w):
        return x
    xf = x.to(torch.float32).reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(xf, size=(out_h, out_w), mode="bilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c).to(x.dtype)
