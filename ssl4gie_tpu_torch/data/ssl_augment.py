"""On-device SSL augmentation (port of `ssl4gie_tpu/data/ssl_augment.py`):
MAE's one view and MoCo v3's two.

`mae_augment` is the reference's MAE recipe (`Models/mae/main_pretrain.py:
123-127`): RandomResizedCrop with area scale [0.2, 1] and log-uniform aspect
ratio [3/4, 4/3] from the fixed host canvas (256 px by default), a
horizontal flip with probability 0.5, then ImageNet normalize. The crop and
resize is a per-image, axis-aligned bilinear resample, as the JAX package
does it: separable, two taps per output pixel, source coordinates clamped
to the canvas edge.

`moco_two_crops` is MoCo v3's BYOL recipe (`Models/moco_v3/main_moco.py:
262-290`), per view: RandomResizedCrop with area scale [0.08, 1], then
ColorJitter(0.4, 0.4, 0.2, 0.1) with probability 0.8 (brightness,
contrast, saturation, hue, in that order), grayscale with probability 0.2,
a 25-tap Gaussian blur of sigma U[0.1, 2] with probability 1.0 (view 1) or
0.1 (view 2), solarize (v >= 0.5 -> 1 - v) with probability 0 (view 1) or
0.2 (view 2), a horizontal flip with probability 0.5, then normalize.

Sampling and applying are split: `sample_mae_params` and
`sample_moco_params` draw every random value from a `torch.Generator`
with the JAX ranges, `mae_augment` and `apply_moco_view` apply explicit
values, copied to the batch's device from pinned memory without blocking
(`data/augment.py:_on`). The pipeline runs in bfloat16 on the card and in
float32 on the CPU, as the classification augmentation (`data/augment.py`)
and the JAX package (bfloat16 on the TPU, float32 on the CPU) do; the
normalized output is float32.
"""

from __future__ import annotations

import math

import torch

from ssl4gie_tpu_torch.data.augment import (_adjust_brightness,
                                            _adjust_contrast, _adjust_hue,
                                            _adjust_saturation, _grayscale,
                                            _on, gaussian_blur, normalize)

MAE_CROP_SCALE = (0.2, 1.0)
MOCO_CROP_SCALE = (0.08, 1.0)
CROP_RATIO = (3 / 4, 4 / 3)
# MoCo v3's per-view ranges and probabilities: ColorJitter(0.4, 0.4, 0.2,
# 0.1) w.p. 0.8, grayscale w.p. 0.2, blur sigma U[0.1, 2] w.p. 1.0 / 0.1,
# solarize w.p. 0 / 0.2
MOCO_JITTER = {"brightness": (0.6, 1.4), "contrast": (0.6, 1.4),
               "saturation": (0.8, 1.2), "hue": (-0.1, 0.1)}
MOCO_JITTER_P, MOCO_GRAY_P = 0.8, 0.2
MOCO_SIGMA = (0.1, 2.0)
MOCO_BLUR_P = (1.0, 0.1)
MOCO_SOLARIZE_P = (0.0, 0.2)


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


def _sampler(B: int, generator: torch.Generator):
    """uniform(lo, hi): (B,) draws U[lo, hi) on the generator's device."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B,), generator=generator,
                                           device=generator.device)
    return uniform


def _sample_crop(uniform, scale, canvas: int) -> torch.Tensor:
    """Crop boxes of area fraction U[scale], log aspect U[log 3/4, log
    4/3], corners U[0, 1) of the free room."""
    area = uniform(*scale)
    log_r = uniform(math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1]))
    ux, uy = uniform(0.0, 1.0), uniform(0.0, 1.0)
    return crop_boxes(area, log_r, ux, uy, canvas, canvas)


def sample_mae_params(B: int, generator: torch.Generator,
                      canvas: int = 256) -> dict:
    """Draw the crop boxes and flips of `mae_augment` on the generator's
    device with the JAX ranges: area fraction U[0.2, 1] (`_sample_crop`),
    flip when U[0, 1) > 0.5."""
    uniform = _sampler(B, generator)
    return {"box": _sample_crop(uniform, MAE_CROP_SCALE, canvas),
            "flip": uniform(0.0, 1.0) > 0.5}


def sample_moco_params(B: int, generator: torch.Generator,
                       canvas: int = 256) -> tuple[dict, dict]:
    """Draw every random value of `moco_two_crops`' two views on the
    generator's device: per view the crop box (area U[0.08, 1]), the
    jitter factors (brightness and contrast U[0.6, 1.4], saturation
    U[0.8, 1.2], hue U[-0.1, 0.1]), the jitter mask (p 0.8), the grayscale
    mask (p 0.2), the blur sigma U[0.1, 2] and its mask (p 1.0, then 0.1),
    the solarize mask (p 0, then 0.2) and the flip (p 0.5); a mask is
    U[0, 1) < p, as `_masked` draws it."""
    uniform = _sampler(B, generator)
    views = []
    for blur_p, solarize_p in zip(MOCO_BLUR_P, MOCO_SOLARIZE_P):
        p = {"box": _sample_crop(uniform, MOCO_CROP_SCALE, canvas)}
        p.update({k: uniform(*r) for k, r in MOCO_JITTER.items()})
        p.update(jitter=uniform(0.0, 1.0) < MOCO_JITTER_P,
                 gray=uniform(0.0, 1.0) < MOCO_GRAY_P,
                 sigma=uniform(*MOCO_SIGMA),
                 blur=uniform(0.0, 1.0) < blur_p,
                 solarize=uniform(0.0, 1.0) < solarize_p,
                 flip=uniform(0.0, 1.0) > 0.5)
        views.append(p)
    return views[0], views[1]


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
    # a tensor divisor: on the card, a Python-scalar divisor becomes a
    # multiplication by its reciprocal, which rounds otherwise than the
    # CPU's (and the JAX package's) division in half the cases
    n = torch.full_like(w, out_size)
    src_x = x0[:, None] + xs[None, :] * (w / n)[:, None]
    src_y = y0[:, None] + xs[None, :] * (h / n)[:, None]

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


def _aug_dtype(img_u8: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if img_u8.is_cuda else torch.float32


def _per_image(mask: torch.Tensor) -> torch.Tensor:
    return mask.reshape(-1, 1, 1, 1)


def mae_augment(img_u8: torch.Tensor, params: dict,
                out_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float32 (B, out, out, 3): the crop
    boxes of `params["box"]`, then the flips of `params["flip"]`."""
    p = _on(params, img_u8.device)
    img = img_u8.to(_aug_dtype(img_u8)) / 255.0
    v = random_resized_crop(img, p["box"], out_size)
    v = torch.where(_per_image(p["flip"]), v.flip(2), v)
    return normalize(v.to(torch.float32))


def apply_moco_view(img: torch.Tensor, params: dict,
                    out_size: int = 224) -> torch.Tensor:
    """One MoCo v3 view of the [0, 1] (B, H, W, 3) batch `img` at the
    values of `params` (one view of `sample_moco_params`, on img's
    device), in img's dtype: crop, jitter (brightness, contrast,
    saturation, hue; factors cast to img's dtype), grayscale, blur,
    solarize, flip; then normalized float32."""
    B, dt = img.shape[0], img.dtype
    v = random_resized_crop(img, params["box"], out_size)
    f4 = lambda k: params[k].to(dt).reshape(B, 1, 1, 1)
    jit = _adjust_brightness(v, f4("brightness"))
    jit = _adjust_contrast(jit, f4("contrast"))
    jit = _adjust_saturation(jit, f4("saturation"))
    jit = _adjust_hue(jit, params["hue"].to(dt).reshape(B, 1, 1))
    v = torch.where(_per_image(params["jitter"]), jit, v)
    v = torch.where(_per_image(params["gray"]), _grayscale(v).expand_as(v), v)
    v = torch.where(_per_image(params["blur"]),
                    gaussian_blur(v, params["sigma"]), v)
    v = torch.where(_per_image(params["solarize"]),
                    torch.where(v >= 0.5, 1.0 - v, v), v)
    v = torch.where(_per_image(params["flip"]), v.flip(2), v)
    return normalize(v.to(torch.float32))


def moco_two_crops(img_u8: torch.Tensor, params: tuple[dict, dict],
                   out_size: int = 224):
    """(B, H, W, 3) uint8 -> the two normalized float32 views (B, out, out,
    3) at the values of `params` (`sample_moco_params`)."""
    img = img_u8.to(_aug_dtype(img_u8)) / 255.0
    return tuple(apply_moco_view(img, _on(p, img_u8.device), out_size)
                 for p in params)
