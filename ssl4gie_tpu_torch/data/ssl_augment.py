"""On-device MAE augmentation (port of the MAE half of
`ssl4gie_tpu/data/ssl_augment.py`).

`mae_augment` is the reference's MAE recipe (`Models/mae/main_pretrain.py:
123-127`): RandomResizedCrop with area scale [0.2, 1] and log-uniform aspect
ratio [3/4, 4/3] from the fixed host canvas (256 px by default), a
horizontal flip with probability 0.5, then ImageNet normalize. The crop and
resize is a per-image, axis-aligned bilinear resample, as the JAX package
does it: separable, two taps per output pixel, source coordinates clamped
to the canvas edge.

Sampling and applying are split: `sample_mae_params` draws the crop boxes
and flips from a `torch.Generator` with the JAX ranges, `mae_augment`
applies explicit boxes and flips. The pipeline runs in bfloat16 on the card
and in float32 on the CPU, as the classification augmentation
(`data/augment.py`) and the JAX package (bfloat16 on the TPU, float32 on the
CPU) do; the normalized output is float32. The MoCo two-crop views wait for
the MoCo slice.
"""

from __future__ import annotations

import math

import torch

from ssl4gie_tpu_torch.data.augment import normalize

MAE_CROP_SCALE = (0.2, 1.0)
CROP_RATIO = (3 / 4, 4 / 3)


def crop_boxes(area_frac, log_ratio, ux, uy, H: int, W: int) -> torch.Tensor:
    """(B,) unit draws -> (B, 4) float32 crop boxes [x0, y0, w, h] on an
    H x W canvas, as `random_resized_crop` computes them: area = area_frac
    * H * W, aspect exp(log_ratio), w and h clipped to [1, W] and [1, H],
    the corner at ux * (W - w), uy * (H - h)."""
    area = area_frac * (H * W)
    r = torch.exp(log_ratio)
    w = torch.clamp(torch.sqrt(area * r), 1.0, W)
    h = torch.clamp(torch.sqrt(area / r), 1.0, H)
    return torch.stack([ux * (W - w), uy * (H - h), w, h], dim=1)


def sample_mae_params(B: int, generator: torch.Generator,
                      canvas: int = 256) -> dict:
    """Draw the crop boxes and flips of `mae_augment` on the generator's
    device with the JAX ranges: area fraction U[0.2, 1], log aspect
    U[log 3/4, log 4/3], corners U[0, 1) of the free room, flip when
    U[0, 1) > 0.5."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B,), generator=generator,
                                           device=dev)

    area = uniform(*MAE_CROP_SCALE)
    log_r = uniform(math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1]))
    ux, uy = uniform(0.0, 1.0), uniform(0.0, 1.0)
    return {"box": crop_boxes(area, log_r, ux, uy, canvas, canvas),
            "flip": torch.rand((B,), generator=generator, device=dev) > 0.5}


def _taps(src: torch.Tensor, n_src: int):
    """(B, L) source coordinates -> the two taps' indices and the second
    tap's weight, edge-clamped (`_interp_matrix`)."""
    src = torch.clamp(src, 0.0, n_src - 1.0)
    i0 = torch.floor(src)
    f = src - i0
    i0 = i0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n_src - 1), f


def random_resized_crop(img: torch.Tensor, box: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """Resample each image's crop box (B, 4) [x0, y0, w, h] to out_size x
    out_size bilinearly: output pixel i samples the source at x0 + i * w /
    out_size (and likewise in y), along x first, then y. img: (B, H, W, C);
    the taps' weights are in img's dtype, as the JAX interpolation matrices
    are."""
    B, H, W, C = img.shape
    box = box.to(device=img.device, dtype=torch.float32)
    x0, y0, w, h = box.unbind(1)
    xs = torch.arange(out_size, dtype=torch.float32, device=img.device)
    src_x = x0[:, None] + xs[None, :] * (w / out_size)[:, None]
    src_y = y0[:, None] + xs[None, :] * (h / out_size)[:, None]

    def lerp(x, src, n_src, dim):
        i0, i1, f = _taps(src, n_src)
        shape = [B, 1, 1, 1]
        shape[dim] = out_size
        idx = lambda i: i.reshape(shape).expand(
            *[out_size if d == dim else s for d, s in enumerate(x.shape)])
        f = f.reshape(shape)
        return (torch.gather(x, dim, idx(i0)) * (1 - f).to(x.dtype)
                + torch.gather(x, dim, idx(i1)) * f.to(x.dtype))

    return lerp(lerp(img, src_x, W, 2), src_y, H, 1)


def mae_augment(img_u8: torch.Tensor, params: dict,
                out_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float32 (B, out, out, 3): the crop
    boxes of `params["box"]`, then the flips of `params["flip"]`."""
    dt = torch.bfloat16 if img_u8.is_cuda else torch.float32
    img = img_u8.to(dt) / 255.0
    v = random_resized_crop(img, params["box"], out_size)
    flip = params["flip"].to(img_u8.device).reshape(-1, 1, 1, 1)
    v = torch.where(flip, v.flip(2), v)
    return normalize(v.to(torch.float32))
