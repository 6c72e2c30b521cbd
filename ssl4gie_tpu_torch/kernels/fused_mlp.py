"""The transformer MLP fused around its hidden activation (port of
`ssl4gie_tpu/kernels/fused_mlp.py`).

`fused_mlp(x, w1, b1, w2, b2, approximate)` keeps the JAX signature:
y = gelu(x.w1 + b1).w2 + b2 with x (..., C), w1 (C, H), w2 (H, C). The port's
`Mlp` passes `fc1.weight.t()` and `fc2.weight.t()`, views of the nn.Linear
weights, so no transpose is copied: the kernels read the weights in their
(out, in) layout.

On CUDA tensors the forward launches `ssl4gie_mlp_fwd` (#8: h = x.w1 + b1
stored bf16, then y = gelu(h).w2 + b2 with the GELU applied in registers to
the A operand, so g = gelu(h) never reaches device memory) and the backward
`ssl4gie_mlp_bwd` (#9: one read of h gives dh = gelu'(h) * (dy.w2^T) and
g = gelu(h)), both on the warp-specialised TMA + wgmma GEMM core of
`csrc/gemm_core.cuh`; dx, dw1, dw2 are then plain GEMMs and db1, db2 float32
sums,
as the JAX package leaves them to XLA. The kernels take bfloat16 and widths C
and H that are multiples of 128; anything else raises. On CPU tensors the
plain PyTorch version below runs, differentiated by autograd: the same
arithmetic, with h and g rounded to the input dtype where the kernels round
them.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels.dense_attention import _check_cuda

WIDTH_MULTIPLE = 128     # C and H: the kernels' 128-wide output tiles


def _gelu(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(h, approximate="tanh" if approximate else "none")


def mlp_fwd_plain(x2, w1, b1, w2, b2, approximate: bool = True):
    """The plain forward on (M, C) tokens: (y, h) in x's dtype, each product
    in float32 (bf16 products are exact in f32), h and g rounded to x's
    dtype where the kernels round them."""
    dt = x2.dtype
    h = (x2.float() @ w1.float() + b1.float()).to(dt)
    g = _gelu(h.float(), approximate).to(dt)
    y = (g.float() @ w2.float() + b2.float()).to(dt)
    return y, h


def mlp_bwd_plain(h, dy, w2, approximate: bool = True):
    """The plain fused backward: (dh, g) in h's dtype from h (M, H), dy
    (M, C) and w2 (H, C)."""
    hf = h.float()
    with torch.enable_grad():
        t = hf.detach().requires_grad_(True)
        (dgelu,) = torch.autograd.grad(_gelu(t, approximate).sum(), t)
    dg = dy.float() @ w2.float().t()
    return (dg * dgelu).to(h.dtype), _gelu(hf, approximate).to(h.dtype)


def fused_mlp_plain(x, w1, b1, w2, b2, approximate: bool = True):
    """The plain version's output, (..., C), differentiable by autograd."""
    y, _ = mlp_fwd_plain(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2,
                         approximate)
    return y.reshape(x.shape)


def _check(C: int, H: int, device, operands) -> None:
    """Raise unless C and H suit the kernels and every (name, tensor, shape)
    of `operands` is a contiguous, aligned bf16 tensor on `device`."""
    if C % WIDTH_MULTIPLE or H % WIDTH_MULTIPLE:
        raise ValueError(f"the CUDA kernels take C and H that are multiples "
                         f"of {WIDTH_MULTIPLE}, got C={C}, H={H}")
    for name, t, shape in operands:
        if t.device != device:
            raise ValueError(f"{name} is not on {device}")
        _check_cuda(name, t, shape)


def mlp_fwd(x2, w1, b1, w2, b2, approximate: bool = True):
    """Forward #8 on (M, C) tokens -> (y (M, C), h (M, H)). w1 (C, H) and w2
    (H, C) must be transposed views of contiguous nn.Linear weights.
    Launches `ssl4gie_mlp_fwd` on CUDA tensors; the plain version on CPU
    tensors."""
    if x2.device.type == "cpu":
        return mlp_fwd_plain(x2, w1, b1, w2, b2, approximate)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    (M, C), H = x2.shape, w1.shape[1]
    _check(C, H, x2.device, (("x", x2, (M, C)), ("w1^T", w1.t(), (H, C)),
                             ("b1", b1, (H,)), ("w2^T", w2.t(), (C, H)),
                             ("b2", b2, (C,))))
    h = torch.empty((M, H), dtype=x2.dtype, device=x2.device)
    y = torch.empty((M, C), dtype=x2.dtype, device=x2.device)
    _build.launch_on(x2.device, "ssl4gie_mlp_fwd", x2.data_ptr(),
                     w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     b2.data_ptr(), h.data_ptr(), y.data_ptr(), M, C, H,
                     int(approximate))
    mlp_fwd.launches += 1
    mlp_fwd.by_width[C] += 1
    return y, h


mlp_fwd.launches = 0
mlp_fwd.by_width = collections.Counter()   # launches by C


def mlp_bwd(h, dy, w2, approximate: bool = True):
    """Backward #9: (h (M, H), dy (M, C), w2 (H, C)) -> (dh, g), both
    (M, H). w2 must be the transposed view of a contiguous nn.Linear weight.
    Launches `ssl4gie_mlp_bwd` on CUDA tensors; the plain version on CPU
    tensors."""
    if h.device.type == "cpu":
        return mlp_bwd_plain(h, dy, w2, approximate)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    (M, H), C = h.shape, dy.shape[-1]
    _check(C, H, h.device, (("h", h, (M, H)), ("dy", dy, (M, C)),
                            ("w2^T", w2.t(), (C, H))))
    dh = torch.empty_like(h)
    g = torch.empty_like(h)
    _build.launch_on(h.device, "ssl4gie_mlp_bwd", h.data_ptr(), dy.data_ptr(),
                     w2.data_ptr(), dh.data_ptr(), g.data_ptr(), M, C, H,
                     int(approximate))
    mlp_bwd.launches += 1
    mlp_bwd.by_width[C] += 1
    return dh, g


mlp_bwd.launches = 0
mlp_bwd.by_width = collections.Counter()   # launches by C


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, approximate):
        x2 = x.reshape(-1, x.shape[-1])
        y, h = mlp_fwd(x2, w1, b1, w2, b2, approximate)
        ctx.save_for_backward(x2, h, w1, w2)
        ctx.approximate = approximate
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, h, w1, w2 = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1]).contiguous()
        dh, g = mlp_bwd(h, dy2, w2, ctx.approximate)
        # the clean GEMMs, in nn.Linear layout (out, in); returned as the
        # (in, out) views the forward was given
        dw2 = (dy2.t() @ g).t()
        dw1 = (dh.t() @ x2).t()
        db2 = dy2.sum(0, dtype=torch.float32).to(w2.dtype)
        db1 = dh.sum(0, dtype=torch.float32).to(w1.dtype)
        dx = (dh @ w1.t()).reshape(dy.shape)
        return dx, dw1, db1, dw2, db2, None


def fused_mlp(x, w1, b1, w2, b2, approximate: bool = True):
    """y = gelu(x.w1 + b1).w2 + b2; x (..., C), w1 (C, H), w2 (H, C).

    CUDA: kernels #8 and #9 through autograd. CPU: the plain version,
    differentiated by autograd."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, approximate)
    return _FusedMLP.apply(x.contiguous(), w1, b1, w2, b2, approximate)
