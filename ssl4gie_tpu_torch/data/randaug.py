"""The timm train-augmentation stack, RandAugment + RandomErasing, and the
linear probe's train transform (port of `ssl4gie_tpu/data/randaug.py`).

Parity targets (the vendored MAE ImageNet finetune recipe):
- `timm.data.auto_augment.rand_augment_transform` with the reference's
  policy `rand-m9-mstd0.5-inc1` (`Models/mae/main_finetune.py:82`), reached
  through `create_transform` (`Models/mae/util/datasets.py:36-48`);
- `timm.data.random_erasing.RandomErasing` with `--reprob 0.25 --remode
  pixel --recount 1` (`main_finetune.py:88-93`);
- the probe train transform, RandomResizedCrop(224) + hflip + normalize
  only (`Models/moco_v3/main_lincls.py:273-274`,
  `Models/mae/main_linprobe.py:133-134`).

Each RandAugment layer (2 by default) draws per image one of the 15 ops,
applies it with probability 0.5 at magnitude N(m, mstd) clipped to [0, 10]
and a sign. The five geometric ops share one batched bilinear warp per
layer (`data/augment.py:affine_sample`, per-channel fill `FILL`; identity
rows resample exactly, so an image without a geometric op passes through
unchanged); the ten photometric ops are computed over the batch and
selected per image. Each layer applies exactly one op per image, so the
selection keeps the reference's sequential semantics.

The op arithmetic is PIL's, as timm calls it, with its integer and
truncation rules: the autocontrast, posterize and solarize LUTs, the L24
grayscale rounding, SMOOTH's border-preserving 3 x 3 kernel, the blend's
clipping. It needs float32, on the card too: bfloat16 cannot carry
`19595 R + 38470 G + 7471 B + 0x8000` nor the LUTs' truncation by `_EPS`.
Equalize's per-image, per-channel histograms are one `(B*C, 256)`
`scatter_add_`, with no host synchronisation.

Sampling and applying are split, as in `data/augment.py`: `sample_*`
draws every random value from a `torch.Generator` (per layer and image the
op, the coin, the magnitude and the sign; for the erasing the ten area
and aspect draws, the offsets and the coin; the crop box and the flip);
`*_batch` applies them. The warp matrices and the erasing rectangles are
made where the values were drawn (the host), so the card and the CPU
sample the same pixels; the erasing's N(0, 1) noise is drawn on the
image's device from a generator seeded by one host draw, or given.
"""

from __future__ import annotations

import math
import re

import torch

from ssl4gie_tpu_torch.data.augment import _on, affine_sample, normalize
from ssl4gie_tpu_torch.data.ssl_augment import (_sample_crop, _sampler,
                                                random_resized_crop)
from ssl4gie_tpu_torch.parallel.distributed import (data_shard, draw_global,
                                                    local_rows)

# timm `rand_augment_ops` fill: tuple(min(255, round(255 * m)) for m in mean)
FILL = (124.0, 116.0, 104.0)
_EPS = 1e-3   # < 1/255, the closest a true LUT value can sit below an integer
N_OPS = 15
GEO_OPS = (3, 11, 12, 13, 14)   # rotate, shear x/y, translate x/y
CROP_SCALE = (0.08, 1.0)        # RandomResizedCrop's default area range
ERASE_ATTEMPTS = 10             # timm's fixed attempt count
ERASE_AREA = (0.02, 1 / 3)
ERASE_MIN_ASPECT = 0.3


def parse_rand_augment(policy: str) -> dict:
    """A timm policy string `rand-m9-mstd0.5-inc1` -> its config (timm
    `rand_augment_transform`'s m/n/p/mstd/inc keys)."""
    parts = policy.split("-")
    if parts[0] != "rand":
        raise ValueError(f"only 'rand-*' auto-augment policies are supported, "
                         f"got {policy!r}")
    cfg = dict(magnitude=9.0, num_layers=2, prob=0.5, mstd=0.0,
               increasing=False)
    for p in parts[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", p)
        if not m:
            raise ValueError(f"unparsable policy segment {p!r} in {policy!r}")
        key, val = m.group(1), float(m.group(2))
        if key == "m":
            cfg["magnitude"] = val
        elif key == "n":
            cfg["num_layers"] = int(val)
        elif key == "p":
            cfg["prob"] = val
        elif key == "mstd":
            cfg["mstd"] = val
        elif key == "inc":
            cfg["increasing"] = bool(int(val))
        else:
            raise ValueError(f"unsupported policy key {key!r} in {policy!r}")
    return cfg


# ---------------------------------------------------------------- PIL op math
# Every op takes and returns a float32 (B, H, W, 3) batch in the uint8 value
# domain [0, 255], integer-valued between ops (PIL quantizes each op to uint8).

def _col(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, 1, 1)


def _l_gray(img):
    """PIL convert('L'): (19595 r + 38470 g + 7471 b + 0x8000) >> 16."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    acc = 19595.0 * r + 38470.0 * g + 7471.0 * b + 32768.0
    return torch.floor(acc / 65536.0 + _EPS)


def _blend(degenerate, img, factor):
    """PIL Image.blend / ImageEnhance: CLIP8((int)(im1 + f * (im2 - im1)))."""
    out = torch.floor(degenerate + factor * (img - degenerate) + _EPS)
    return torch.clamp(out, 0.0, 255.0)


def auto_contrast(img):
    """ImageOps.autocontrast(cutoff=0): per-channel stretch, int() LUT."""
    lo = torch.amin(img, dim=(1, 2), keepdim=True)
    hi = torch.amax(img, dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    out = torch.floor((img - lo) * scale + _EPS)
    return torch.where(hi > lo, torch.clamp(out, 0.0, 255.0), img)


def equalize(img):
    """ImageOps.equalize: per image and channel, lut[i] = (step // 2 +
    sum(h[:i])) // step with step = (n_px - h[255]) // 255 (identity when
    step is 0); the histograms are one scatter_add_."""
    B, H, W, C = img.shape
    pix = img.to(torch.int64).permute(0, 3, 1, 2).reshape(B * C, H * W)
    hist = torch.zeros((B * C, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, pix, torch.ones_like(pix))
    step = (H * W - hist[:, 255]) // 255                       # (B*C,)
    cum = torch.cumsum(hist, dim=1) - hist                     # sum(h[:i])
    lut = (step[:, None] // 2 + cum) // torch.clamp(step, min=1)[:, None]
    lut = torch.clamp(lut, 0, 255)
    out = torch.gather(lut, 1, pix)
    out = torch.where(step[:, None] > 0, out, pix)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1).to(img.dtype)


def invert(img):
    return 255.0 - img


def posterize(img, bits):
    """ImageOps.posterize: keep the top `bits` (B,) int bits."""
    shift = _col(torch.exp2(8.0 - bits.to(torch.float32)))
    out = torch.floor(img / shift) * shift
    return torch.where(_col(bits) >= 8, img, out)


def solarize(img, thresh):
    """ImageOps.solarize: invert pixels >= thresh (B,)."""
    return torch.where(img < _col(thresh), img, 255.0 - img)


def solarize_add(img, add, thresh: float = 128.0):
    """timm solarize_add: lut[i] = min(255, i + add) for i < thresh."""
    return torch.where(img < thresh, torch.clamp(img + _col(add), 0.0, 255.0),
                       img)


def adjust_color(img, factor):
    """ImageEnhance.Color: blend(grayscale, img, factor)."""
    gray = _l_gray(img)[..., None].expand(img.shape)
    return _blend(gray, img, factor)


def adjust_contrast(img, factor):
    """ImageEnhance.Contrast: blend(solid int(mean_L + .5), img, factor)."""
    mean = torch.floor(torch.mean(_l_gray(img), dim=(1, 2)) + 0.5 + _EPS)
    return _blend(_col(mean).expand(img.shape), img, factor)


def adjust_brightness(img, factor):
    """ImageEnhance.Brightness: blend(black, img, factor)."""
    return _blend(torch.zeros_like(img), img, factor)


def adjust_sharpness(img, factor):
    """ImageEnhance.Sharpness: blend(img.filter(SMOOTH), img, factor).
    SMOOTH = [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, rounded half up; PIL
    leaves the 1-px border of the filtered image as the source."""
    # the float32 quotients k / 13, divided on the host (the card would
    # multiply by the reciprocal of 13, another rounding)
    w = torch.tensor([k / 13.0 for k in (1, 1, 1, 1, 5, 1, 1, 1, 1)],
                     dtype=torch.float32, device=img.device)
    acc = torch.zeros_like(img)
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + w[k] * torch.roll(img, (-dy, -dx), dims=(1, 2))
            k += 1
    smooth = torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)
    H, W = img.shape[1], img.shape[2]
    yi = torch.arange(H, device=img.device)[None, :, None, None]
    xi = torch.arange(W, device=img.device)[None, None, :, None]
    interior = (yi > 0) & (yi < H - 1) & (xi > 0) & (xi < W - 1)
    return _blend(torch.where(interior, smooth, img), img, factor)


# ------------------------------------------------------- geometric matrices
# Centered inverse-affine rows (m00 m01 m02 m10 m11 m12) for affine_sample.
# PIL's AFFINE matrices map output to input with a top-left origin; in the
# centered form m02 += m00 * cx + m01 * cy - cx (and m12 likewise), which
# the rotation (already centered) does not need.

def _geo_matrix(op, applied, mag, sign, H: int, W: int) -> torch.Tensor:
    """Per-image (B, 6) inverse matrices of ops 3/11/12/13/14, identity
    rows for every other (or unapplied) op."""
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    B = op.shape[0]
    one = torch.ones(B, dtype=torch.float32, device=op.device)
    zero = torch.zeros_like(one)
    ident = torch.stack([one, zero, zero, zero, one, zero], dim=-1)
    v = sign * mag
    # Rotate: PIL img.rotate(deg), the inverse map about the centre
    a = -torch.deg2rad(v * 3.0)
    rot = torch.stack([torch.cos(a), torch.sin(a), zero,
                       -torch.sin(a), torch.cos(a), zero], dim=-1)
    # ShearX: src_x = x + f * y (top-left) -> centered m02 = f * cy
    f = v * 0.03
    shx = torch.stack([one, f, f * cy, zero, one, zero], dim=-1)
    shy = torch.stack([one, zero, zero, f, one, f * cx], dim=-1)
    # TranslateXRel/YRel: pixels = f * dim, src = out + pixels
    t = v * 0.045
    trx = torch.stack([one, zero, t * W, zero, one, zero], dim=-1)
    try_ = torch.stack([one, zero, zero, zero, one, t * H], dim=-1)
    m = ident
    for i, mat in zip(GEO_OPS, (rot, shx, shy, trx, try_)):
        m = torch.where(((op == i) & applied)[:, None], mat, m)
    return m


def _op_args(mag, sign, increasing: bool):
    """timm's level_to_arg functions: (posterize bits, solarize threshold,
    solarize_add amount, enhance factor), truncated like int()."""
    if increasing:
        bits = 4 - torch.floor(mag * 0.4 + _EPS).to(torch.int32)
        thresh = 256.0 - torch.floor(mag * 25.6 + _EPS)
        enh = torch.clamp(1.0 + sign * mag * 0.09, min=0.1)
    else:
        bits = torch.floor(mag * 0.4 + _EPS).to(torch.int32)
        thresh = torch.floor(mag * 25.6 + _EPS)
        enh = (mag / 10.0) * 1.8 + 0.1
    return bits, thresh, torch.floor(mag * 11.0 + _EPS), enh


def sample_rand_augment(B: int, generator: torch.Generator,
                        policy_cfg: dict) -> list[dict]:
    """Per layer, per image: the op (uniform over the 15), applied
    (U[0, 1) < prob), the magnitude N(m, mstd) clipped to [0, 10] and the
    sign (-1 when U[0, 1) > 0.5, else 1), on the generator's device."""
    dev = generator.device
    layers = []
    for _ in range(policy_cfg["num_layers"]):
        op = torch.randint(0, N_OPS, (B,), generator=generator, device=dev)
        applied = torch.rand((B,), generator=generator,
                             device=dev) < policy_cfg["prob"]
        mag = policy_cfg["magnitude"] + policy_cfg["mstd"] * torch.randn(
            (B,), generator=generator, device=dev)
        sign = torch.where(torch.rand((B,), generator=generator,
                                      device=dev) > 0.5, -1.0, 1.0)
        layers.append({"op": op, "applied": applied,
                       "mag": torch.clamp(mag, 0.0, 10.0), "sign": sign})
    return layers


def rand_augment_layer(img, layer: dict, increasing: bool,
                       matrix: torch.Tensor | None = None):
    """One RandAugment layer on a [0, 255] float32 batch at `layer`'s
    values (`sample_rand_augment`); `matrix` is its warp (`_geo_matrix`),
    made from `layer` when not given."""
    B, H, W, _ = img.shape
    op, applied, mag, sign = (layer[k] for k in ("op", "applied", "mag",
                                                 "sign"))
    if matrix is None:
        matrix = _geo_matrix(op, applied, mag, sign, H, W)
    img = affine_sample(img, matrix, FILL, mode="bilinear")
    img = torch.clamp(torch.floor(img + 0.5), 0.0, 255.0)   # PIL's uint8

    sel = lambda i: _col((op == i) & applied)
    bits, thresh, add, enh = _op_args(mag, sign, increasing)
    enh4 = _col(enh)
    img = torch.where(sel(0), auto_contrast(img), img)
    img = torch.where(sel(1), equalize(img), img)
    img = torch.where(sel(2), invert(img), img)
    img = torch.where(sel(4), posterize(img, bits), img)
    img = torch.where(sel(5), solarize(img, thresh), img)
    img = torch.where(sel(6), solarize_add(img, add), img)
    img = torch.where(sel(7), adjust_color(img, enh4), img)
    img = torch.where(sel(8), adjust_contrast(img, enh4), img)
    img = torch.where(sel(9), adjust_brightness(img, enh4), img)
    img = torch.where(sel(10), adjust_sharpness(img, enh4), img)
    return img


def rand_augment(img, layers: list[dict], increasing: bool,
                 matrices: list | None = None):
    """Every layer of `layers` on a [0, 255] float32 batch, in order, each
    with its warp of `matrices` when given."""
    for i, layer in enumerate(layers):
        img = rand_augment_layer(img, layer, increasing,
                                 None if matrices is None else matrices[i])
    return img


# ------------------------------------------------------------ random erasing

def sample_erasing(B: int, generator: torch.Generator) -> dict:
    """timm RandomErasing's draws per image: ten attempts' area fractions
    U[0.02, 1/3] and log aspects U[log 0.3, log 1/0.3], the two offsets'
    U[0, 1) and the coin U[0, 1)."""
    dev = generator.device
    u = lambda shape: torch.rand(shape, generator=generator, device=dev)
    A = ERASE_ATTEMPTS
    lo = math.log(ERASE_MIN_ASPECT)
    return {"area": ERASE_AREA[0] + (ERASE_AREA[1] - ERASE_AREA[0]) * u((B, A)),
            "log_r": lo + (-lo - lo) * u((B, A)),
            "top": u((B,)), "left": u((B,)), "coin": u((B,))}


def erase_boxes(params: dict, prob: float, H: int, W: int) -> torch.Tensor:
    """(B, 5) int64 [apply, top, left, h, w] of the first attempt that fits
    (area * H * W, aspect exp(log_r), h and w rounded half to even, both
    below the image's); apply is the coin below `prob` with a fitting
    attempt; randint(0, H - h) is inclusive of both ends."""
    area = params["area"] * H * W
    ar = torch.exp(params["log_r"])
    h = torch.round(torch.sqrt(area * ar)).to(torch.int64)
    w = torch.round(torch.sqrt(area / ar)).to(torch.int64)
    valid = (h < H) & (w < W)
    first = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)
    h, w = torch.gather(h, 1, first)[:, 0], torch.gather(w, 1, first)[:, 0]
    top = torch.floor(params["top"] * (H - h + 1)).to(torch.int64)
    left = torch.floor(params["left"] * (W - w + 1)).to(torch.int64)
    apply = (params["coin"] < prob) & valid.any(dim=1)
    return torch.stack([apply.to(torch.int64), top, left, h, w], dim=1)


def random_erasing(img, boxes: torch.Tensor, noise: torch.Tensor):
    """Replace each image's box (`erase_boxes`) of the normalized batch by
    `noise` (timm's re_mode='pixel', after Normalize)."""
    B, H, W, _ = img.shape
    apply, top, left, h, w = (_col(c)[..., 0] for c in boxes.unbind(1))
    yi = torch.arange(H, device=img.device)[None, :, None]
    xi = torch.arange(W, device=img.device)[None, None, :]
    mask = ((yi >= top) & (yi < top + h) & (xi >= left) & (xi < left + w)
            & (apply > 0))
    return torch.where(mask[..., None], noise, img)


# ---------------------------------------------------------------- pipelines

def sample_probe_params(B: int, H: int, generator: torch.Generator) -> dict:
    """The probe transform's crop boxes (area U[0.08, 1] of an H x H
    canvas) and flips (U[0, 1) > 0.5)."""
    uniform = _sampler(B, generator)
    return {"box": _sample_crop(uniform, CROP_SCALE, H),
            "flip": uniform(0.0, 1.0) > 0.5}


def _crop_flip(img, p: dict, out_size: int):
    v = random_resized_crop(img, p["box"], out_size)
    return torch.where(_col(p["flip"]), v.flip(2), v)


def probe_train_batch(img_u8: torch.Tensor, params: dict,
                      out_size: int = 224) -> torch.Tensor:
    """The linear probe's train transform: RandomResizedCrop + hflip +
    normalize only, float32 (none of the GI-task jitter, blur or
    rotation)."""
    p = _on(params, img_u8.device)
    img = img_u8.to(torch.float32) / 255.0
    return normalize(_crop_flip(img, p, out_size))


def sample_timm_params(B: int, H: int, generator: torch.Generator,
                       policy: str = "rand-m9-mstd0.5-inc1",
                       reprob: float = 0.25) -> dict:
    """Every draw of `timm_train_batch` on an H x H canvas: the crop box
    (area U[0.08, 1]) and flip, the RandAugment layers (none for an empty
    `policy`), the erasing's draws and the seed of its noise (none when
    `reprob` is 0)."""
    params = sample_probe_params(B, H, generator)
    cfg = parse_rand_augment(policy) if policy else None
    params["increasing"] = bool(cfg and cfg["increasing"])
    params["ra"] = sample_rand_augment(B, generator, cfg) if cfg else []
    params["reprob"] = reprob
    if reprob > 0:
        params["erase"] = sample_erasing(B, generator)
        params["noise_seed"] = int(torch.randint(
            0, 2**62, (1,), generator=generator,
            device=generator.device).item())
    return params


def erasing_noise(shape, seed: int, device) -> torch.Tensor:
    """The erasing's N(0, 1) float32 noise, drawn on `device` from a
    generator seeded `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def timm_train_batch(img_u8: torch.Tensor, params: dict, out_size: int = 224,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
    """timm's `create_transform(is_training=True)` stack of the MAE
    finetune recipe (`Models/mae/util/datasets.py:36-48`) at the draws of
    `params` (`sample_timm_params`): RandomResizedCrop (rounded to uint8
    values, as PIL's crop) + hflip + RandAugment + normalize +
    RandomErasing, in float32. `noise` (B, out, out, 3) replaces the
    erasing's own draw."""
    dev = img_u8.device
    H = out_size
    mats = [_geo_matrix(l["op"], l["applied"], l["mag"], l["sign"], H, H)
            for l in params["ra"]]
    boxes = (erase_boxes(params["erase"], params["reprob"], H, H)
             if params["reprob"] > 0 else None)
    on = _on({"box": params["box"], "flip": params["flip"], "boxes": boxes,
              **{f"m{i}": m for i, m in enumerate(mats)}}, dev)
    img = img_u8.to(torch.float32)
    v = torch.clamp(torch.floor(random_resized_crop(img, on["box"], out_size)
                                + 0.5), 0.0, 255.0)
    v = torch.where(_col(on["flip"]), v.flip(2), v)
    v = rand_augment(v, [_on(layer, dev) for layer in params["ra"]],
                     params["increasing"],
                     [on[f"m{i}"] for i in range(len(mats))])
    v = normalize(v / 255.0)
    if boxes is None:
        return v
    if noise is None:
        noise = erasing_noise(v.shape, params["noise_seed"], dev)
    return random_erasing(v, on["boxes"], noise.to(dev))


def make_probe_aug(out_size: int = 224, accum_steps: int = 1):
    """The probe transform as a task's `aug_fn`: (img_u8, generator) ->
    normalized float32 batch, its draws made for the global batch under
    data parallelism (`distributed.draw_global`; `accum_steps` is the
    step's microbatch count)."""
    def aug(img_u8, generator):
        B, H = img_u8.shape[:2]
        return probe_train_batch(img_u8, draw_global(
            sample_probe_params, B, H, generator, accum_steps=accum_steps),
            out_size)
    return aug


def make_timm_aug(out_size: int = 224, policy: str = "rand-m9-mstd0.5-inc1",
                  reprob: float = 0.25, accum_steps: int = 1):
    """The timm stack as a task's `aug_fn`: (img_u8, generator) ->
    normalized float32 batch, drawn as `make_probe_aug`'s."""
    def aug(img_u8, generator):
        B, H = img_u8.shape[:2]
        params = draw_global(sample_timm_params, B, H, generator, policy,
                             reprob, accum_steps=accum_steps)
        noise = None
        _, n = data_shard()
        if n > 1 and reprob > 0:     # the global batch's erasing noise
            rows = local_rows(B * n, accum_steps)
            noise = erasing_noise((B * n, out_size, out_size, 3),
                                  params["noise_seed"], img_u8.device)[
                torch.as_tensor(rows, device=img_u8.device)]
        return timm_train_batch(img_u8, params, out_size, noise)
    return aug
