"""Nearest rotation by Paeth 3-shear.

Port of `ssl4gie_tpu/kernels/rotate.py:shear_rotate_pallas`: rotate each image
of a (B, H, W, C) canvas by the shears x(alpha) y(beta) x(alpha), alpha =
tan(r/2) and beta = -sin(r), writing `fill` where a pass reads outside the
image. Element for element the same as the JAX package's shear passes
(`data/augment.py:rotate_nearest_shear`) and as `shear_rotate_pallas` with
any pad P larger than the largest x-shift: the TPU pads its canvas by P
columns only so that its circular rolls do not wrap, and the pad cancels
out of the composed index chain, so the port takes no P.

`quarter` (optional, (B,) int32) also applies the rot90 fold of
`rotate_nearest_shear` first (q quarter turns per image), so the caller can
hand over the unfolded image.

On a CUDA tensor this runs the kernel of `csrc/rotate.cu` (bf16): one block
per 32 x 32 output tile of an image, which follows each pixel's index chain
once, stages the tile's source box in shared memory by 16-byte cp.async
copies along the image's rows and writes the tile by 16-byte stores. On a CPU tensor it runs
the plain PyTorch version below.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.kernels import _build


def rot90_fold(img: torch.Tensor, quarter: torch.Tensor) -> torch.Tensor:
    """Per image, g[y, x] = img[rot90^q(y, x)] for q = quarter mod 4 (as
    `data/augment.py:rotate_nearest_shear` folds it; square images)."""
    qm = torch.remainder(quarter, 4).reshape(-1, 1, 1, 1)
    xt = img.transpose(1, 2)
    return torch.where(qm == 0, img,
           torch.where(qm == 1, xt.flip(2),
           torch.where(qm == 2, img.flip((1, 2)), xt.flip(1))))


def _shift(factor: torch.Tensor, pos: torch.Tensor, c: float) -> torch.Tensor:
    # one f32 multiply, rounded half to even (jnp.round / torch.round)
    return torch.round(factor * (pos.to(torch.float32) - c)).to(torch.int64)


def shear_rotate_plain(g, alpha, beta, fill: float, quarter=None):
    """The plain version: the three shear passes composed into one gather."""
    if quarter is not None:
        g = rot90_fold(g, quarter)
    B, H, W, C = g.shape
    c = (H - 1) / 2.0
    dev = g.device
    a = alpha.to(torch.float32).reshape(B, 1, 1)
    be = beta.to(torch.float32).reshape(B, 1, 1)
    y = torch.arange(H, device=dev).reshape(1, H, 1)
    x = torch.arange(W, device=dev).reshape(1, 1, W)
    u = x + _shift(a, y, c)                           # pass C source column - P
    y2 = y + _shift(be, u, c)                         # pass B source row
    x2 = u + _shift(a, y2, c)                         # pass A source column
    valid = (y2 >= 0) & (y2 < H) & (x2 >= 0) & (x2 < W)
    flat = (y2.clamp(0, H - 1) * W + x2.clamp(0, W - 1)).reshape(B, H * W, 1)
    src = torch.gather(g.reshape(B, H * W, C), 1, flat.expand(B, H * W, C))
    fill_t = torch.full((), fill, dtype=g.dtype, device=dev)
    return torch.where(valid.reshape(B, H, W, 1), src.reshape(B, H, W, C),
                       fill_t)


def shear_rotate(g: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 fill: float, quarter=None) -> torch.Tensor:
    """g: (B, H, W, C); alpha, beta: (B,) f32 shear factors; quarter: None or
    (B,) int32 quarter turns to fold first (square g). Returns (B, H, W, C)."""
    if g.device.type == "cpu":
        return shear_rotate_plain(g, alpha, beta, fill, quarter)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if g.dim() != 4 or g.numel() == 0:
        raise ValueError(f"g must be a non-empty (B, H, W, C), got "
                         f"{tuple(g.shape)}")
    B, H, W, C = g.shape
    if B > 65535 or max(H, W) >= 32768:
        raise ValueError(f"the CUDA kernel takes B <= 65535 and H, W < 32768, "
                         f"got {tuple(g.shape)}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous g")
    args = [(alpha, "alpha", torch.float32), (beta, "beta", torch.float32)]
    if quarter is not None:
        if H != W:
            raise ValueError("the rot90 fold needs square images")
        args.append((quarter, "quarter", torch.int32))
    for t, name, dt in args:
        if (t.dtype != dt or tuple(t.shape) != (B,) or not t.is_contiguous()
                or t.device != g.device):
            raise ValueError(f"{name} must be a contiguous ({B},) {dt} tensor "
                             f"on {g.device}")
    out = torch.empty_like(g)
    _build.launch_on(g.device, "ssl4gie_shear_rotate", g.data_ptr(),
                     alpha.data_ptr(), beta.data_ptr(),
                     None if quarter is None else quarter.data_ptr(),
                     out.data_ptr(), B, H, W, C, float(fill))
    shear_rotate.launches += 1
    return out


shear_rotate.launches = 0
