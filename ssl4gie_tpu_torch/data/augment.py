"""On-device train augmentation (port of `ssl4gie_tpu/data/augment.py`).

Two branches of `_augment_train_batch`:
- classification: color jitter (exact HSV hue, one op order per batch), a
  25-tap Gaussian blur with one sigma per image, joint h/v flips, a nearest
  rotation in [-180, 180) degrees by rot90 fold + Paeth 3-shear (fill 0, on
  the unnormalized image), then ImageNet normalize;
- segmentation: jitter and blur, normalize, h/v flips of the image and its
  mask together, then the joint random affine `fast_random_affine` (image
  fill -1, mask fill 0): scale and translation, an x-shear, and the
  rotation by the rotation kernel on a 352 px canvas that holds the image,
  the mask and a validity channel;
- depth: jitter and blur, normalize, h/v flips of the image and its depth
  map together, and no warp.

Each op is split into sampling and applying: `sample_*_params` draws every
random factor from a `torch.Generator`, `apply_*` applies them. Images are
NHWC, (B, H, W, C). The pipeline runs in bfloat16 on the card and in float32
on the CPU, with the same algorithm on both (the JAX package runs
`fast_random_affine` in bfloat16 on its accelerator); the normalized output
is float32, the mask or depth map keeps its dtype.
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
# the reference's seg RandomAffine (`Binary_segmentation/Data/dataset.py`), as
# `fast_random_affine`'s defaults
AFFINE_TRANSLATE = 0.125
AFFINE_SCALE = (0.5, 1.5)
AFFINE_SHEAR = 22.5
IMG_FILL, TARGET_FILL = -1.0, 0.0   # post-normalize fills, as TF.affine's


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

def _uniform(shape, lo, hi, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _on(params: dict, device) -> dict:
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in params.items()}


def _sample_jitter_blur_flips(B: int, generator: torch.Generator) -> dict:
    """Jitter factors U[1-x, 1+x] (hue U[-h, h]) and one op order per batch
    (`color_jitter`), blur sigma U[0.001, 2] (`gaussian_blur`), flips with
    probability 0.5 (`random_flips`)."""
    dev = generator.device
    params = {name: _uniform((B,), 1 - x, 1 + x, generator)
              for name, x in JITTER.items()}
    params.update(
        hue=_uniform((B,), -HUE, HUE, generator),
        order=torch.randperm(4, generator=generator, device=dev).tolist(),
        sigma=_uniform((B,), *SIGMA_RANGE, generator),
        hflip=torch.rand((B,), generator=generator, device=dev) > 0.5,
        vflip=torch.rand((B,), generator=generator, device=dev) > 0.5)
    return params


def sample_classification_params(B: int, generator: torch.Generator) -> dict:
    """Draw every random factor of the classification augmentation on the
    generator's device, with the JAX package's ranges: jitter, blur and
    flips (`_sample_jitter_blur_flips`), then the angle U[-180, 180)
    (`_augment_train_batch`)."""
    params = _sample_jitter_blur_flips(B, generator)
    params["angle"] = _uniform((B,), -DEGREES, DEGREES, generator)
    return params


def apply_classification(img_u8: torch.Tensor, params: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float32 (B, H, W, 3): jitter + blur ->
    flips -> rotation (fill 0) -> normalize, with the factors of `params`."""
    dt = torch.bfloat16 if img_u8.is_cuda else torch.float32
    p = _on(params, img_u8.device)
    img = img_u8.to(dt) / 255.0
    img = color_jitter(img, p["brightness"], p["contrast"], p["saturation"],
                       p["hue"], p["order"])
    img = gaussian_blur(img, p["sigma"])
    img = random_flips(img, p["hflip"], p["vflip"])
    img = rotate_nearest_shear(img, p["angle"], fill=0.0)
    return normalize(img.to(torch.float32))


# ---------------------------------------------------------------- affine

def inverse_affine_matrix(angle_deg, translate, scale, shear_deg):
    """torchvision's `_get_inverse_affine_matrix` with center (0, 0), as the
    JAX package's `_inverse_affine_matrix`: the (B, 6) rows of the 2x3
    matrix from centered output to centered input coordinates. angle,
    scale, shear: (B,); translate: (B, 2) pixels."""
    rot = torch.deg2rad(angle_deg)
    sx = torch.deg2rad(shear_deg)
    sy = torch.zeros_like(sx)
    tx, ty = translate[:, 0], translate[:, 1]
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    inv_scale = 1.0 / scale
    m00, m01 = d * inv_scale, -b * inv_scale
    m10, m11 = -c * inv_scale, a * inv_scale
    m02 = m00 * (-tx) + m01 * (-ty)
    m12 = m10 * (-tx) + m11 * (-ty)
    return torch.stack([m00, m01, m02, m10, m11, m12], dim=-1)


def sample_affine_params(B: int, size: int, generator: torch.Generator
                         ) -> dict:
    """The random affine's factors, with `fast_random_affine`'s ranges: the
    angle U[-180, 180), the translation U[-1/8, 1/8) of the image size
    `size` in pixels (B, 2) (x, y), the scale U[0.5, 1.5) and the x-shear
    U[-22.5, 22.5) degrees."""
    return {"angle": _uniform((B,), -DEGREES, DEGREES, generator),
            "translate": _uniform((B, 2), -AFFINE_TRANSLATE,
                                  AFFINE_TRANSLATE, generator) * float(size),
            "scale": _uniform((B,), *AFFINE_SCALE, generator),
            "shear": _uniform((B,), -AFFINE_SHEAR, AFFINE_SHEAR, generator)}


def affine_canvases(size: int) -> tuple[int, int]:
    """(S1, S2) of `fast_random_affine` for a `size` px image: the scale
    canvas (512 at 224 px) and the rotation canvas (352), S1 wide enough
    for the x-shear's reads (its shift bound K on each side)."""
    s2 = int(math.ceil(352 * size / 224 / 8.0)) * 8
    k = int(math.ceil(math.tan(math.pi / 8) * (s2 - 1) / 2.0)) + 1
    s1 = max(int(math.ceil(512 * size / 224 / 8.0)) * 8, s2 + 2 * k)
    return s1, s2


def _scale_shear_gather(x: torch.Tensor, params: dict, s1: int,
                        s2: int) -> torch.Tensor:
    """Passes 1 and 2 of `fast_random_affine` as one gather onto the S2
    canvas. Pass 1 samples t1[p, q] = x[iy(p), ix(q)] on the S1 canvas
    (zero outside the image); pass 2 x-shears it, t2[y, x] = t1[y + off,
    x + off + k(y)]. The JAX package computes them as one-hot matmuls and
    binary roll/selects, which pick the same elements: element for element
    the same."""
    B, H, W, C = x.shape
    dev = x.device
    m = inverse_affine_matrix(params["angle"], params["translate"],
                              params["scale"], params["shear"])
    inv_s = 1.0 / params["scale"]
    u = torch.tan(torch.deg2rad(params["shear"]))      # x-shear factor
    tx, ty = m[:, 2], m[:, 5]
    c_in, c1, c2 = (H - 1) / 2.0, (s1 - 1) / 2.0, (s2 - 1) / 2.0
    grid1 = torch.arange(s1, dtype=torch.float32, device=dev) - c1
    ix = torch.round(grid1[None, :] * inv_s[:, None] + tx[:, None] + c_in
                     ).to(torch.int64)                  # (B, S1)
    iy = torch.round(grid1[None, :] * inv_s[:, None] + ty[:, None] + c_in
                     ).to(torch.int64)
    off = (s1 - s2) // 2
    y2 = torch.arange(s2, dtype=torch.float32, device=dev) - c2
    k = torch.round(u[:, None] * y2[None, :]).to(torch.int64)   # (B, S2)
    rows = iy[:, off:off + s2]                                  # (B, S2)
    qcol = (torch.arange(s2, device=dev)[None, None, :] + off
            + k[:, :, None])                                    # in [0, S1)
    cols = torch.gather(ix[:, None, :].expand(B, s2, s1), 2, qcol)
    valid = (rows >= 0)[:, :, None] & (rows < H)[:, :, None] & \
        (cols >= 0) & (cols < W)
    flat = rows.clamp(0, H - 1)[:, :, None] * W + cols.clamp(0, W - 1)
    src = torch.gather(x.reshape(B, H * W, C), 1,
                       flat.reshape(B, s2 * s2, 1).expand(B, s2 * s2, C))
    return torch.where(valid.reshape(B, s2, s2, 1), src.reshape(B, s2, s2, C),
                       torch.zeros((), dtype=x.dtype, device=dev))


def apply_affine(img: torch.Tensor, target: torch.Tensor | None,
                 params: dict):
    """`fast_random_affine` at the factors of `params`
    (`sample_affine_params`): img (B, H, W, C) square, target (B, H, W, Ct)
    or None. The image, the target (in the image dtype; exact for 0/1
    masks) and a validity channel go onto one canvas; scale, translation
    and the x-shear are one gather onto the S2 canvas (352 px at 224), the
    rotation is the rotation kernel with its rot90 fold (fill 0); then the
    center crop, and the validity channel puts IMG_FILL and TARGET_FILL
    where no source pixel landed. Returns (img, target in its dtype)."""
    B, H, W, C = img.shape
    if H != W:
        raise ValueError("apply_affine requires square images")
    p = {k: params[k].to(img.device)
         for k in ("angle", "translate", "scale", "shear")}
    parts = [img]
    if target is not None:
        parts.append(target.to(img.dtype))
    parts.append(torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device))
    s1, s2 = affine_canvases(H)
    t2 = _scale_shear_gather(torch.cat(parts, dim=-1), p, s1, s2)
    t3 = rotate_nearest_shear(t2, p["angle"], fill=0.0)
    lo = (s2 - H) // 2
    t3 = t3[:, lo:lo + H, lo:lo + W]
    valid = t3[..., -1:] > 0.5
    out_img = torch.where(valid, t3[..., :C], _const(IMG_FILL, img))
    if target is None:
        return out_img, None
    out_tgt = torch.where(valid, t3[..., C:-1], _const(TARGET_FILL, img))
    return out_img, out_tgt.to(target.dtype)


def sample_segmentation_params(B: int, size: int,
                               generator: torch.Generator) -> dict:
    """Every random factor of the segmentation augmentation: jitter, blur
    and flips (`_sample_jitter_blur_flips`), then the affine
    (`sample_affine_params`)."""
    params = _sample_jitter_blur_flips(B, generator)
    params.update(sample_affine_params(B, size, generator))
    return params


def _dense_photometric_flips(img_u8: torch.Tensor, target: torch.Tensor,
                             p: dict):
    """The dense branches' first half: jitter + blur -> normalize -> joint
    flips of the image and its target, in the pipeline's dtype (the
    target in its own)."""
    dt = torch.bfloat16 if img_u8.is_cuda else torch.float32
    img = img_u8.to(dt) / 255.0
    img = color_jitter(img, p["brightness"], p["contrast"], p["saturation"],
                       p["hue"], p["order"])
    img = normalize(gaussian_blur(img, p["sigma"]))
    return (random_flips(img, p["hflip"], p["vflip"]),
            random_flips(target, p["hflip"], p["vflip"]))


def apply_segmentation(img_u8: torch.Tensor, mask: torch.Tensor,
                       params: dict):
    """(B, H, W, 3) uint8 and its (B, H, W, Ct) mask -> (normalized float32
    image, mask in its dtype): jitter + blur -> normalize -> joint flips ->
    joint affine (fill -1 image, 0 mask), with the factors of `params`."""
    p = _on(params, img_u8.device)
    img, mask = _dense_photometric_flips(img_u8, mask, p)
    img, mask = apply_affine(img, mask, p)
    return img.to(torch.float32), mask


def sample_depth_params(B: int, generator: torch.Generator) -> dict:
    """Every random factor of the depth augmentation: jitter, blur and flips
    (`_sample_jitter_blur_flips`)."""
    return _sample_jitter_blur_flips(B, generator)


def apply_depth(img_u8: torch.Tensor, depth: torch.Tensor, params: dict):
    """(B, H, W, 3) uint8 and its (B, H, W, 1) depth map -> (normalized
    float32 image, depth map in its dtype): jitter + blur -> normalize ->
    joint flips, with the factors of `params`."""
    img, depth = _dense_photometric_flips(img_u8, depth,
                                          _on(params, img_u8.device))
    return img.to(torch.float32), depth
