"""On-device classification augmentation (port of `ssl4gie_tpu/data/augment.py`).

The classification branch of `_augment_train_batch`: color jitter (exact HSV
hue, one op order per batch), a 25-tap Gaussian blur with one sigma per image,
joint h/v flips, a nearest rotation in [-180, 180) degrees by rot90 fold +
Paeth 3-shear (fill 0, on the unnormalized image), then ImageNet normalize.

Each op is split into sampling and applying: `sample_classification_params`
draws every random factor from a `torch.Generator`, `apply_classification`
applies them. Images are NHWC, (B, H, W, C). The pipeline runs in bfloat16 on
the card and in float32 on the CPU, as the JAX package runs it in bfloat16 on
the TPU and in float32 on the CPU; the normalized output is float32.
"""

from __future__ import annotations

import math

import torch

from ssl4gie_tpu_torch.kernels.rotate import shear_rotate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the reference's ColorJitter(0.4, 0.5, 0.25, 0.01), GaussianBlur(25, sigma
# U[0.001, 2]) and RandomRotation(180), as the JAX package's defaults
JITTER = {"brightness": 0.4, "contrast": 0.5, "saturation": 0.25}
HUE = 0.01
BLUR_TAPS = 25
SIGMA_RANGE = (0.001, 2.0)
DEGREES = 180.0


def _const(values, like: torch.Tensor) -> torch.Tensor:
    # f32 first, then the image dtype, as the JAX constants are cast
    return torch.tensor(values, dtype=torch.float32,
                        device=like.device).to(like.dtype)


def normalize(img: torch.Tensor) -> torch.Tensor:
    return (img - _const(IMAGENET_MEAN, img)) / _const(IMAGENET_STD, img)


def eval_batch(img_u8: torch.Tensor) -> torch.Tensor:
    """Eval-time: scale to [0, 1] and normalize, in float32."""
    return normalize(img_u8.to(torch.float32) / 255.0)


# ---------------------------------------------------------------- color jitter

def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def _grayscale(img):
    return torch.sum(img * _const((0.299, 0.587, 0.114), img), dim=-1,
                     keepdim=True)


def _adjust_brightness(img, f):
    return torch.clamp(img * f, 0.0, 1.0)


def _adjust_contrast(img, f):
    mean = torch.mean(_grayscale(img), dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean, f)


def _adjust_saturation(img, f):
    return _blend(img, _grayscale(img), f)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.amax(img, dim=-1)
    minc = torch.amin(img, dim=-1)
    v = maxc
    deltac = maxc - minc
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-12), zero)
    safe_d = torch.where(deltac > 0, deltac, torch.ones_like(deltac))
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(options):
        out = options[-1]
        for idx in range(len(options) - 2, -1, -1):
            out = torch.where(i == idx, options[idx], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _adjust_hue(img, f):
    # f: (B, 1, 1) broadcasting over the (B, H, W) hue plane
    h, s, v = _rgb_to_hsv(img)
    return _hsv_to_rgb(torch.remainder(h + f, 1.0), s, v)


def color_jitter(img, brightness, contrast, saturation, hue, order):
    """Apply the four jitter ops in `order` (a permutation of 0..3 for
    brightness, contrast, saturation, hue) with per-image factors (B,)."""
    B = img.shape[0]
    f4 = lambda f: f.to(img.dtype).reshape(B, 1, 1, 1)
    ops = (lambda x: _adjust_brightness(x, f4(brightness)),
           lambda x: _adjust_contrast(x, f4(contrast)),
           lambda x: _adjust_saturation(x, f4(saturation)),
           lambda x: _adjust_hue(x, hue.to(img.dtype).reshape(B, 1, 1)))
    for idx in order:
        img = ops[idx](img)
    return img


# ---------------------------------------------------------------- gaussian blur

def _reflect_index(n: int, k: int, device) -> torch.Tensor:
    i = torch.arange(-k, n + k, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def blur_weights(sigma: torch.Tensor) -> torch.Tensor:
    """(B,) sigmas -> (B, BLUR_TAPS) normalized Gaussian taps in float32."""
    k = BLUR_TAPS // 2
    xs = torch.arange(-k, k + 1, dtype=torch.float32,
                      device=sigma.device)[None, :]
    w = torch.exp(-0.5 * (xs / sigma.to(torch.float32).reshape(-1, 1)) ** 2)
    return w / torch.sum(w, dim=1, keepdim=True)


def gaussian_blur(img, sigma):
    """Separable Gaussian with one sigma per image and reflect padding, as 25
    shifted adds per axis in the image dtype."""
    B, H, W, C = img.shape
    k = BLUR_TAPS // 2
    w = blur_weights(sigma).to(img.dtype)

    def conv_axis(x, axis):
        n = x.shape[axis]
        xp = x.index_select(axis, _reflect_index(n, k, x.device))
        out = torch.zeros_like(x)
        for i in range(BLUR_TAPS):
            out = out + xp.narrow(axis, i, n) * w[:, i].reshape(B, 1, 1, 1)
        return out

    return conv_axis(conv_axis(img, 1), 2)


# ---------------------------------------------------------------- geometric

def random_flips(img, hflip, vflip):
    """Per-image flips; hflip, vflip: (B,) bool."""
    B = img.shape[0]
    img = torch.where(hflip.reshape(B, 1, 1, 1), img.flip(2), img)
    return torch.where(vflip.reshape(B, 1, 1, 1), img.flip(1), img)


def rotation_factors(angle_deg: torch.Tensor):
    """Fold each angle to 90q + r with r in [-45, 45] degrees. Returns
    (q mod 4 as int32, alpha = tan(r/2), beta = -sin(r)), as the JAX
    package's `rotate_nearest_shear` computes them."""
    theta = torch.deg2rad(angle_deg.to(torch.float32))
    q = torch.round(theta / (0.5 * math.pi))
    r = theta - q * (0.5 * math.pi)
    return (torch.remainder(q, 4).to(torch.int32), torch.tan(r / 2.0),
            -torch.sin(r))


def rotate_nearest_shear(img, angle_deg, fill: float = 0.0):
    """Nearest rotation by `angle_deg` (B,) degrees: the rot90 fold and the
    three shears, both done by the rotation kernel on the card."""
    B, H, W, C = img.shape
    if H != W:
        raise ValueError("rotate_nearest_shear requires square images")
    q, alpha, beta = rotation_factors(angle_deg)
    return shear_rotate(img.contiguous(), alpha.contiguous(),
                        beta.contiguous(), fill, quarter=q.contiguous())


# ---------------------------------------------------------------- pipeline

def sample_classification_params(B: int, generator: torch.Generator) -> dict:
    """Draw every random factor of the classification augmentation on the
    generator's device, with the JAX package's ranges: jitter factors
    U[1-x, 1+x] (hue U[-h, h]) and one op order per batch (`color_jitter`),
    blur sigma U[0.001, 2] (`gaussian_blur`), flips with probability 0.5
    (`random_flips`) and the angle U[-180, 180) (`_augment_train_batch`)."""
    dev = generator.device

    def uniform(lo, hi):
        u = torch.rand((B,), generator=generator, device=dev)
        return lo + (hi - lo) * u

    params = {name: uniform(1 - x, 1 + x) for name, x in JITTER.items()}
    params.update(
        hue=uniform(-HUE, HUE),
        order=torch.randperm(4, generator=generator, device=dev).tolist(),
        sigma=uniform(*SIGMA_RANGE),
        hflip=torch.rand((B,), generator=generator, device=dev) > 0.5,
        vflip=torch.rand((B,), generator=generator, device=dev) > 0.5,
        angle=uniform(-DEGREES, DEGREES))
    return params


def apply_classification(img_u8: torch.Tensor, params: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float32 (B, H, W, 3): jitter + blur ->
    flips -> rotation (fill 0) -> normalize, with the factors of `params`."""
    dt = torch.bfloat16 if img_u8.is_cuda else torch.float32
    p = {k: v.to(img_u8.device) if torch.is_tensor(v) else v
         for k, v in params.items()}
    img = img_u8.to(dt) / 255.0
    img = color_jitter(img, p["brightness"], p["contrast"], p["saturation"],
                       p["hue"], p["order"])
    img = gaussian_blur(img, p["sigma"])
    img = random_flips(img, p["hflip"], p["vflip"])
    img = rotate_nearest_shear(img, p["angle"], fill=0.0)
    return normalize(img.to(torch.float32))
