"""Plain float32 versions of the two train augmentations, and the random
draws that feed them.

The draws are made in the order and with the calls that the configuration's
step makes them, from a host `torch.Generator` seeded as the benchmark
seeds the step's, so that the reference samples the same factors.

Classification (the SSL4GIE reference's ColorJitter(0.4, 0.5, 0.25, 0.01),
GaussianBlur(25, sigma U[0.001, 2]), both flips and RandomRotation(180), as
the JAX package defines them): the four jitter ops in one random order a
batch, a 25-tap separable Gaussian with reflect padding, horizontal then
vertical flips, a nearest rotation by a quarter-turn fold and Paeth's three
shears (fill 0), ImageNet normalize.

MAE (`main_pretrain.py`: RandomResizedCrop(scale (0.2, 1)), a horizontal
flip, normalize): the crop resampled bilinearly, separably, two taps a
pixel, output pixel i at x0 + i w / out, edges clamped; as the JAX
package defines it, which differs from torchvision's half-pixel crop.

The program runs both in bfloat16 on the card; the control runs them with
every op's result rounded to fp8 (`plain.rounding`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# ------------------------------------------------------------------ draws

def _uniform(B: int, lo: float, hi: float, gen: torch.Generator):
    return lo + (hi - lo) * torch.rand((B,), generator=gen, device=gen.device)


def draw_classification(B: int, gen: torch.Generator) -> dict:
    """Jitter factors U[1 - x, 1 + x] for brightness 0.4, contrast 0.5,
    saturation 0.25, one op order, hue U[-0.01, 0.01], sigma U[0.001, 2],
    flips with p 0.5, angle U[-180, 180)."""
    p = {name: _uniform(B, 1 - x, 1 + x, gen)
         for name, x in (("brightness", 0.4), ("contrast", 0.5),
                         ("saturation", 0.25))}
    p["order"] = torch.randperm(4, generator=gen, device=gen.device).tolist()
    p["hue"] = _uniform(B, -0.01, 0.01, gen)
    p["sigma"] = _uniform(B, 0.001, 2.0, gen)
    p["hflip"] = torch.rand((B,), generator=gen, device=gen.device) > 0.5
    p["vflip"] = torch.rand((B,), generator=gen, device=gen.device) > 0.5
    p["angle"] = _uniform(B, -180.0, 180.0, gen)
    return p


def draw_mae(B: int, gen: torch.Generator, patches: int) -> dict:
    """Crop area fraction U[0.2, 1], log aspect U[log 3/4, log 4/3],
    corners U[0, 1), flip U[0, 1) > 0.5, then the masking noise U[0, 1)
    (B, patches)."""
    area = _uniform(B, 0.2, 1.0, gen)
    log_r = _uniform(B, math.log(3 / 4), math.log(4 / 3), gen)
    ux, uy = _uniform(B, 0.0, 1.0, gen), _uniform(B, 0.0, 1.0, gen)
    flip = _uniform(B, 0.0, 1.0, gen) > 0.5
    noise = torch.rand((B, patches), generator=gen, device=gen.device)
    return {"area": area, "log_r": log_r, "ux": ux, "uy": uy, "flip": flip,
            "noise": noise}


# ------------------------------------------------------------------ ops

def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=img.device)
    std = torch.tensor(STD, device=img.device)
    return (img - mean) / std


def _gray(img):
    return (img * torch.tensor((0.299, 0.587, 0.114),
                               device=img.device)).sum(-1, keepdim=True)


def _blend(a, b, f):
    return (b + f * (a - b)).clamp(0.0, 1.0)


def _hue_shift(img, f):
    """RGB -> HSV, h + f mod 1, -> RGB (torchvision's formulas)."""
    r, g, b = img.unbind(-1)
    maxc, minc = img.amax(-1), img.amin(-1)
    d = maxc - minc
    s = torch.where(maxc > 0, d / maxc.clamp(min=1e-12), torch.zeros_like(d))
    dd = torch.where(d > 0, d, torch.ones_like(d))
    rc, gc, bc = (maxc - r) / dd, (maxc - g) / dd, (maxc - b) / dd
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    h = torch.remainder(h + f, 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    fr = h * 6.0 - i
    i = torch.remainder(i.to(torch.int64), 6)
    p, q, t = v * (1 - s), v * (1 - fr * s), v * (1 - (1 - fr) * s)
    table = torch.stack([torch.stack(c, -1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v),
                          (t, p, v), (v, p, q))], -2)        # (..., 6, 3)
    return torch.gather(table, -2, i[..., None, None].expand(
        *i.shape, 1, 3))[..., 0, :]


def color_jitter(img, p: dict, rnd=lambda x: x):
    """The four ops in `p["order"]`, each result rounded by `rnd`."""
    B = img.shape[0]
    f = lambda k: p[k].reshape(B, 1, 1, 1)
    ops = (lambda x: (x * f("brightness")).clamp(0.0, 1.0),
           lambda x: _blend(x, _gray(x).mean(dim=(1, 2, 3), keepdim=True),
                            f("contrast")),
           lambda x: _blend(x, _gray(x), f("saturation")),
           lambda x: _hue_shift(x, p["hue"].reshape(B, 1, 1)))
    for k in p["order"]:
        img = rnd(ops[k](img))
    return img


def gaussian_blur(img, sigma, taps: int = 25, rnd=None):
    """Separable Gaussian of `taps` taps, one sigma an image, reflect
    padding; along H, then W. With `rnd` (the control) each axis is summed
    as the program sums it, tap by tap, every partial sum and the taps
    rounded by `rnd`."""
    B, H, W, C = img.shape
    k = taps // 2
    xs = torch.arange(-k, k + 1, dtype=torch.float32, device=img.device)
    w = torch.exp(-0.5 * (xs[None, :] / sigma[:, None]) ** 2)
    w = w / w.sum(1, keepdim=True)                               # (B, taps)
    x = img.permute(0, 3, 1, 2)                                  # NCHW
    for dim in (2, 3):
        pad = (0, 0, k, k) if dim == 2 else (k, k, 0, 0)
        x = F.pad(x, pad, mode="reflect")
        if rnd is None:
            x = torch.einsum("bchwk,bk->bchw", x.unfold(dim, taps, 1), w)
            continue
        n = x.shape[dim] - 2 * k
        wr = rnd(w)
        out = torch.zeros_like(x.narrow(dim, 0, n))
        for i in range(taps):
            out = rnd(out + rnd(x.narrow(dim, i, n) * wr[:, i].reshape(
                B, 1, 1, 1)))
        x = out
    return x.permute(0, 2, 3, 1)


def flips(img, p: dict):
    B = img.shape[0]
    img = torch.where(p["hflip"].reshape(B, 1, 1, 1), img.flip(2), img)
    return torch.where(p["vflip"].reshape(B, 1, 1, 1), img.flip(1), img)


def rotate(img, angle_deg, fill: float = 0.0):
    """Nearest rotation of square images: fold the angle to 90 q + r with
    |r| <= 45 degrees, turn by q quarters, then the shears x(tan r/2),
    y(-sin r), x(tan r/2) about the center, each shift rounded half to
    even; `fill` where a pass reads outside the image."""
    B, H, W, C = img.shape
    theta = torch.deg2rad(angle_deg)
    q = torch.round(theta / (0.5 * math.pi))
    r = theta - q * (0.5 * math.pi)
    q = torch.remainder(q, 4).reshape(B, 1, 1, 1)
    xt = img.transpose(1, 2)
    img = torch.where(q == 0, img, torch.where(
        q == 1, xt.flip(2), torch.where(q == 2, img.flip((1, 2)), xt.flip(1))))
    a = torch.tan(r / 2.0).reshape(B, 1, 1)
    b = (-torch.sin(r)).reshape(B, 1, 1)
    c = (H - 1) / 2.0
    y = torch.arange(H, device=img.device).reshape(1, H, 1)
    x = torch.arange(W, device=img.device).reshape(1, 1, W)
    shift = lambda f, t: torch.round(f * (t.to(torch.float32) - c)).long()
    u = x + shift(a, y)
    y2 = y + shift(b, u)
    x2 = u + shift(a, y2)
    ok = (y2 >= 0) & (y2 < H) & (x2 >= 0) & (x2 < W)
    idx = (y2.clamp(0, H - 1) * W + x2.clamp(0, W - 1)).reshape(B, H * W, 1)
    out = torch.gather(img.reshape(B, H * W, C), 1, idx.expand(B, H * W, C))
    return torch.where(ok.reshape(B, H, W, 1), out.reshape(B, H, W, C),
                       torch.full((), fill, device=img.device))


def classification(img_u8: torch.Tensor, p: dict,
                   rnd=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float32, at the draws `p`; `rnd`
    rounds each op's result (the control's lower precision)."""
    exact = rnd is None
    rnd = rnd or (lambda x: x)
    p = {k: (v.to(img_u8.device) if torch.is_tensor(v) else v)
         for k, v in p.items()}
    img = rnd(img_u8.to(torch.float32) / 255.0)
    img = gaussian_blur(color_jitter(img, p, rnd), p["sigma"],
                        rnd=None if exact else rnd)
    return normalize(rotate(flips(img, p), p["angle"]))


def mae(img_u8: torch.Tensor, p: dict, out: int,
        rnd=None) -> torch.Tensor:
    """(B, S, S, 3) uint8 canvases -> normalized float32 (B, out, out, 3)
    crops, at the draws `p`; `rnd` rounds each op's result (the control's
    lower precision)."""
    rnd = rnd or (lambda x: x)
    B, H, W, C = img_u8.shape
    dev = img_u8.device
    area = p["area"].to(dev) * (H * W)
    ratio = torch.exp(p["log_r"].to(dev))
    w = torch.sqrt(area * ratio).clamp(1.0, W)
    h = torch.sqrt(area / ratio).clamp(1.0, H)
    x0, y0 = p["ux"].to(dev) * (W - w), p["uy"].to(dev) * (H - h)
    i = torch.arange(out, dtype=torch.float32, device=dev)
    img = rnd(img_u8.to(torch.float32) / 255.0)

    def resample(x, start, length, n, dim):
        step = length / torch.full_like(length, out)     # a true division
        src = (start[:, None] + i[None, :] * step[:, None]).clamp(0.0, n - 1.0)
        i0 = torch.floor(src)
        f = src - i0
        i0 = i0.long()
        i1 = (i0 + 1).clamp(max=n - 1)
        shape = [B, 1, 1, 1]
        shape[dim] = out
        size = list(x.shape)
        size[dim] = out
        take = lambda idx: torch.gather(x, dim,
                                        idx.reshape(shape).expand(size))
        f = f.reshape(shape)
        return take(i0) * (1 - f) + take(i1) * f

    v = rnd(resample(rnd(resample(img, x0, w, W, 2)), y0, h, H, 1))
    v = torch.where(p["flip"].to(dev).reshape(B, 1, 1, 1), v.flip(2), v)
    return normalize(v)
