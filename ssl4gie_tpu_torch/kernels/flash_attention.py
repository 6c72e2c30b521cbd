"""Blockwise (flash-style) attention for long sequences, with key masking.

Port of `ssl4gie_tpu/kernels/flash_attention.py:flash_attention` and
`flash_attention_heads`. q, k, v are (BH, N, D) with batch and heads folded;
N is a multiple of Q_BLOCK and keys >= n_valid are masked; a head width D
that is not a multiple of 64 is zero-padded to one (`_pad_d`), which changes
no product. The forward also returns each row's log-sum-exp (BH, N) f32; the
backward reads it with the saved output.

On a CUDA tensor the forward and backward run the hand-written kernels of
`csrc/flash_attention.cu` (D = 64 after padding; the bf16 or the float32
instance by the tensors' dtype, counted apart as `launches` and
`launches_f32`; anything else raises). On a CPU tensor they run the plain PyTorch version below, which is
also what the kernels are checked against on the card. The gradient of a
masked (padded) key is zero in both, the masked function's own gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels.dense_attention import (HEAD_DIM, _check_cuda,
                                                       _count, _entry)

Q_BLOCK = 256
MASK_VALUE = -1e30        # the masked score, as the Pallas kernel's


def _n_valid(N: int, n_valid) -> int:
    n = N if n_valid is None else int(n_valid)
    if not 1 <= n <= N:
        raise ValueError(f"n_valid must be in [1, {N}], got {n_valid}")
    return n


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float, n_valid=None):
    """The plain version: softmax attention in f32 with keys >= n_valid
    masked. Returns the output in q's dtype and the f32 log-sum-exp (BH, N).
    Differentiable through autograd."""
    N = k.shape[1]
    n = _n_valid(N, n_valid)
    s = (q.float() @ k.float().transpose(-2, -1)) * scale
    if n < N:
        col = torch.arange(N, device=s.device)
        s = torch.where(col < n, s, torch.full((), MASK_VALUE,
                                               device=s.device))
    o = torch.softmax(s, dim=-1) @ v.float()
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_plain(q, k, v, scale: float, n_valid=None) -> torch.Tensor:
    """The plain version's output alone."""
    return flash_attention_fwd_plain(q, k, v, scale, n_valid)[0]


def flash_attention_bwd_plain(q, k, v, dout, scale: float, n_valid=None):
    """The plain backward: (dq, dk, dv) of the plain version, in q's dtype."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*xs, scale, n_valid)
        return torch.autograd.grad(o, xs, dout)


def _check_qkv(q, k, v):
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, N, D), got {tuple(q.shape)}")
    BH, N, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for D={HEAD_DIM}, got {D}")
    if N % 64:
        raise ValueError(f"the CUDA kernel takes N a multiple of 64, got {N}")
    _entry("q", q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} and q must be on one device")
        _check_cuda(name, t, (BH, N, D), q.dtype)
    return BH, N


def flash_fwd(q, k, v, scale: float, n_valid=None):
    """Forward: (BH, N, 64) each -> (o (BH, N, 64), lse (BH, N) f32).
    Launches the online-softmax forward `attn_fwd` on CUDA tensors; the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    BH, N = _check_qkv(q, k, v)
    n = _n_valid(N, n_valid)
    o = torch.empty_like(q)
    lse = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    _build.launch_on(q.device, _entry("ssl4gie_flash_fwd", q), q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     BH, N, n, float(scale))
    _count(flash_fwd, q)
    return o, lse


flash_fwd.launches = flash_fwd.launches_f32 = 0


def flash_bwd(q, k, v, o, lse, dout, scale: float, n_valid=None):
    """Backward: (q, k, v, the forward's o and lse, dO) -> (dq, dk, dv).
    Launches the backward core's `attn_bwd_dq` then `attn_bwd_dkv` on CUDA
    tensors; on CPU tensors the gradient of the plain version (which needs
    neither o nor lse)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, scale, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    BH, N = _check_qkv(q, k, v)
    n = _n_valid(N, n_valid)
    _check_cuda("o", o, (BH, N, HEAD_DIM), q.dtype)
    _check_cuda("dout", dout, (BH, N, HEAD_DIM), q.dtype)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (BH, N)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous ({BH}, {N}) float32 tensor "
                         "on q's device")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)          # scratch: rowsum(dO * O)
    _build.launch_on(q.device, _entry("ssl4gie_flash_bwd", q), q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), BH, N, n, float(scale))
    _count(flash_bwd, q)
    return dq, dk, dv


flash_bwd.launches = flash_bwd.launches_f32 = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid):
        o, lse = flash_fwd(q, k, v, scale, n_valid)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, n_valid)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None


def _pad_d(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return x if d % 64 == 0 else F.pad(x, (0, 64 - d % 64))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, n_valid=None) -> torch.Tensor:
    """q, k, v: (BH, N, D) -> (BH, N, D). Non-causal full attention.

    N must be a multiple of Q_BLOCK; when the true sequence is shorter the
    caller zero-pads to N and passes the true length as `n_valid`. CUDA: the
    kernels, through autograd. CPU: the plain version, through autograd."""
    N, d0 = q.shape[1], q.shape[-1]
    if N % Q_BLOCK:
        raise ValueError(f"N={N} is not a multiple of Q_BLOCK={Q_BLOCK}")
    qp, kp, vp = _pad_d(q), _pad_d(k), _pad_d(v)
    if q.device.type == "cpu":
        o = flash_attention_plain(qp, kp, vp, scale, n_valid)
    else:
        o = _FlashAttention.apply(qp.contiguous(), kp.contiguous(),
                                  vp.contiguous(), scale, n_valid)
    return o[..., :d0] if o.shape[-1] != d0 else o


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Adapter matching `models.layers.plain_attention`: q, k, v (B, H, N,
    Dh). Sequences that are not a multiple of Q_BLOCK are zero-padded up to
    it and masked through `n_valid`."""
    B, H, N, Dh = q.shape
    fold = lambda x: x.reshape(B * H, N, Dh)
    if N % Q_BLOCK == 0:
        return flash_attention(fold(q), fold(k), fold(v), scale).reshape(
            B, H, N, Dh)
    npad = Q_BLOCK - N % Q_BLOCK
    pad = lambda x: F.pad(fold(x), (0, 0, 0, npad))
    o = flash_attention(pad(q), pad(k), pad(v), scale, N)
    return o[:, :N].reshape(B, H, N, Dh)
