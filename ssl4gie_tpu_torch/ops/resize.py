"""Bilinear resizes (port of `ssl4gie_tpu/ops/resize.py`, and of the
`jax.image.resize(..., "bilinear")` calls of the held-out evaluation).

- `resize_bilinear_ac`: align_corners=True, the models' resize. The JAX
  package builds it as two static matmuls for the TPU's matrix unit; here
  it is `F.interpolate(mode="bilinear", align_corners=True)` in float32,
  the same function.
- `resize_bilinear`: `jax.image.resize`'s bilinear, half-pixel centers;
  when it shrinks, its triangle filter widens by the scale (antialiasing),
  which `F.interpolate` does only with `antialias=True`. Without it the
  two agree when enlarging and differ when shrinking.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, out_h: int, out_w: int,
                 **kw) -> torch.Tensor:
    *lead, h, w, c = x.shape
    xf = x.to(torch.float32).reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(xf, size=(out_h, out_w), mode="bilinear", **kw)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c).to(x.dtype)


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize a (..., H, W, C) tensor (H, W at dims -3, -2) with
    align_corners=True bilinear interpolation, computed in float32 and
    returned in the input dtype."""
    if (out_h, out_w) == tuple(x.shape[-3:-1]):
        return x
    return _interpolate(x, out_h, out_w, align_corners=True)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(x, (..., out_h, out_w, C), "bilinear")` on a (...,
    H, W, C) tensor: half-pixel centers, antialiased when shrinking;
    computed in float32, returned in the input dtype. One axis at a time
    (the filter is separable), each antialiased only where it shrinks:
    torch's antialiased path also enlarges, but rounds some 1e-5 away from
    JAX's weights where the plain one does not."""
    h, w = x.shape[-3], x.shape[-2]
    if out_h != h:
        x = _interpolate(x, out_h, w, align_corners=False,
                         antialias=out_h < h)
    if out_w != w:
        x = _interpolate(x, out_h, out_w, align_corners=False,
                         antialias=out_w < w)
    return x
