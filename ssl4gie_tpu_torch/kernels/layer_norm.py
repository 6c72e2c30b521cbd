"""LayerNorm over the last dim of bfloat16 rows with float32 statistics,
scale and bias, in one pass each way.

It replaces no TPU kernel: the JAX package's bf16 LayerNorm is flax's
`nn.LayerNorm(dtype=bfloat16)` with float32 scale and bias, which XLA fuses
(convert, statistics, normalisation, affine) into one pass that reads the
bf16 row and writes the bf16 result. `layer_norm_plain` is the port's
formula for it, the same rounding points: the row cast to float32, torch's
float32 LayerNorm with the float32 scale and bias, the result rounded to
bfloat16 once; its gradient rounds dx once and keeps dgamma and dbeta in
float32. Run eagerly that is three passes forward and four backward.

On CUDA tensors `layer_norm_fwd` launches `ssl4gie_layer_norm_fwd` and
`layer_norm_bwd` launches `ssl4gie_layer_norm_bwd` (`csrc/layer_norm.cu`:
the input gradient and the float32 partial sums of dgamma and dbeta in one
pass over dy and x, then a small kernel that sums the partials, in a fixed
order). Both are bound by bytes: 4 bytes an element forward, 6 backward.
They take contiguous bfloat16 rows x (..., C) with C a multiple of 8 up to
2,048 and float32 scale and bias; anything else raises. The forward keeps
the rows' mean and rstd as one (2, M) float32 `stats` for the backward. On
CPU tensors the plain version runs, on (M, C) rows.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels.dense_attention import _check_cuda

MAX_WIDTH = 2048
WIDTH_MULTIPLE = 8          # 16-byte chunks of 8 bf16
BLOCKS_PER_SM = 2           # the backward's grid (its `__launch_bounds__`)
_BF16, _F32 = torch.bfloat16, torch.float32


def layer_norm_fwd_plain(x2, weight, bias, eps: float):
    """The plain forward on (M, C) rows: (y in x's dtype, stats (2, M)
    float32: the rows' mean, then their rstd), by torch's float32
    LayerNorm."""
    y, mean, rstd = torch.native_layer_norm(x2.float(), (x2.shape[-1],),
                                            weight, bias, eps)
    return y.to(x2.dtype), torch.stack([mean.reshape(-1), rstd.reshape(-1)])


def layer_norm_bwd_plain(dy2, x2, stats, weight):
    """The plain backward: (dx in x's dtype, dgamma, dbeta float32)."""
    mean, rstd = stats[0, :, None], stats[1, :, None]
    xhat = (x2.float() - mean) * rstd
    dyf = dy2.float()
    g = dyf * weight
    c = x2.shape[-1]
    dx = rstd * (g - g.sum(-1, keepdim=True) / c
                 - xhat * (g * xhat).sum(-1, keepdim=True) / c)
    return dx.to(x2.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def layer_norm_plain(x, weight, bias, eps: float):
    """Today's formula, differentiable by autograd: the rows in float32,
    torch's LayerNorm, the result in x's dtype."""
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],), weight, bias,
                        eps).to(x.dtype)


def _check(x, *operands) -> tuple[int, int]:
    """(M, C) of the rows of x (..., C) after raising unless x is a
    contiguous, 16-byte aligned bf16 tensor of a width that the kernels
    take and each (name, tensor, dtype, shape) of `operands` is a
    contiguous, aligned tensor of that dtype and shape on x's device. One
    pass of cheap tests first: the wrapper runs 84 times a MAE step, on the
    host's critical path."""
    device = x.device
    for name, t, dtype, shape in (("x", x, _BF16, x.shape), *operands):
        if (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != device):
            if t.device != device:
                raise ValueError(f"{name} is not on {device}")
            _check_cuda(name, t, shape, dtype)
    c = x.shape[-1] if x.dim() else 0
    if c % WIDTH_MULTIPLE or not WIDTH_MULTIPLE <= c <= MAX_WIDTH:
        raise ValueError(f"the CUDA kernel takes widths that are multiples of "
                         f"{WIDTH_MULTIPLE} up to {MAX_WIDTH}, got {c}")
    m = x.numel() // c
    if m < 1:
        raise ValueError("the CUDA kernel takes at least one row")
    return m, c


def layer_norm_fwd(x, weight, bias, eps: float):
    """Rows x (..., C) bf16 -> (y (..., C) bf16, stats (2, M) f32: the M
    rows' mean, then their rstd). Launches `ssl4gie_layer_norm_fwd` on
    CUDA tensors; the plain version on CPU tensors (rows (M, C))."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    c = x.shape[-1] if x.dim() else 0
    m, c = _check(x, ("weight", weight, _F32, (c,)),
                  ("bias", bias, _F32, (c,)))
    y = torch.empty_like(x)
    stats = torch.empty((2, m), dtype=_F32, device=x.device)
    _build.launch_on(x.device, "ssl4gie_layer_norm_fwd", x.data_ptr(),
                     weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                     stats.data_ptr(), m, c, eps)
    layer_norm_fwd.launches += 1
    layer_norm_fwd.by_width[c] += 1
    return y, stats


layer_norm_fwd.launches = 0
layer_norm_fwd.by_width = collections.Counter()   # launches by C


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _parts(M: int, C: int, device: torch.device) -> int:
    """The backward's blocks: a block takes 8 rows at a time (4 above 1,024
    columns); at most BLOCKS_PER_SM blocks an SM, each walking the rows."""
    rows = 8 if C <= 1024 else 4
    return min(-(-M // rows), BLOCKS_PER_SM * _sms(device))


def layer_norm_bwd(dy, x, stats, weight):
    """(dy, x (..., C) bf16, the forward's stats (2, M) f32, weight (C,)
    f32) -> (dx (..., C) bf16, dgamma, dbeta (C,) f32). Launches
    `ssl4gie_layer_norm_bwd` (two kernels: the pass over the rows, the sum
    of the partial rows) on CUDA tensors, counted once; the plain version
    on CPU tensors (rows (M, C))."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(dy, x, stats, weight)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    c = x.shape[-1] if x.dim() else 0
    m = x.numel() // c if c else 0
    _check(x, ("dy", dy, _BF16, x.shape), ("stats", stats, _F32, (2, m)),
           ("weight", weight, _F32, (c,)))
    return _bwd(dy, x, stats, weight)


def _bwd(dy, x, stats, weight):
    """The backward's launch on operands that suit the kernels."""
    c = x.shape[-1]
    m = x.numel() // c
    parts = _parts(m, c, x.device)
    dx = torch.empty_like(x)
    grads = torch.empty((2, c), dtype=_F32, device=x.device)
    part = torch.empty((2, parts, c), dtype=_F32, device=x.device)
    dw, db = grads.unbind()
    _build.launch_on(x.device, "ssl4gie_layer_norm_bwd", dy.data_ptr(),
                     x.data_ptr(), stats.data_ptr(), weight.data_ptr(),
                     dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     part.data_ptr(), m, c, parts)
    layer_norm_bwd.launches += 1
    layer_norm_bwd.by_width[c] += 1
    return dx, dw, db


layer_norm_bwd.launches = 0
layer_norm_bwd.by_width = collections.Counter()   # launches by C


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, stats = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, stats, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        # x, stats and the weight were checked in the forward, and autograd
        # hands over dy with y's shape, dtype and device: only its layout
        # is left to check
        x, stats, weight = ctx.saved_tensors
        dy = dy.contiguous()
        if dy.data_ptr() % 16:
            raise ValueError("dy: the CUDA kernel needs 16-byte alignment")
        return (*_bwd(dy, x, stats, weight), None)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm of x (..., C) over C with float32 scale and bias; the
    result in x's dtype.

    CUDA: the kernels through autograd (x bf16 and contiguous; under
    no_grad the forward alone, saving nothing). CPU: the plain version,
    differentiated by autograd."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)[0]
