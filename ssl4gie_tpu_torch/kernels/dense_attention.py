"""Packed-QKV multi-head attention for short sequences (N <= 512).

Port of `ssl4gie_tpu/kernels/dense_attention.py:fused_qkv_attention`. The
input is the raw (B, N, 3C) output of the qkv Linear, columns
[q_0..q_{H-1} | k_0..k_{H-1} | v_0..v_{H-1}], each head Dh wide; the output is
(B, N, C). The forward also returns each row's log-sum-exp (B, H, N); the
backward recomputes the softmax from qkv and that log-sum-exp and returns a
packed dqkv, so no head split or merge copies surround the kernels.

On a CUDA tensor the forward and backward run the hand-written kernels of
`csrc/dense_attention.cu` at Dh = 32, 64 or 80, the instance of the
tensor's dtype: bf16 on the tensor cores (`csrc/attention_core.cuh`),
float32 with a 3xTF32 `wgmma` forward and backward
(`csrc/attention_tf32.cuh`); any other dtype or head width raises. Each wrapper counts its launches per dtype, `launches` (bf16) and
`launches_f32`, and per (dtype, Dh) in `launches_by_dh`. On a CPU tensor
they run the plain PyTorch version below, which is also what the kernels
are checked against on the card.
"""

from __future__ import annotations

import collections

import torch

from ssl4gie_tpu_torch.kernels import _build

MAX_FUSED_SEQ = 512
HEAD_DIMS = (32, 64, 80)   # the head widths csrc/dense_attention.cu is built for
HEAD_DIM = 64              # the one head width of the window and flash kernels
# the kernels' instances: a tensor's dtype -> the suffix of its C entry points
INSTANCES = {torch.bfloat16: "", torch.float32: "_f32"}


def _split(shape, num_heads: int):
    B, N, C3 = shape
    if C3 % (3 * num_heads) != 0:
        raise ValueError(f"qkv width {C3} is not 3 * num_heads * Dh "
                         f"(num_heads={num_heads})")
    return B, N, C3 // 3, C3 // (3 * num_heads)


def fused_qkv_attention_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                  scale: float):
    """The plain version: head-split softmax attention in f32. Returns the
    output in the input dtype and the f32 log-sum-exp of each row's scaled
    scores, (B, H, N). Differentiable through autograd."""
    B, N, C, Dh = _split(qkv.shape, num_heads)
    t = qkv.float().reshape(B, N, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    s = (t[0] @ t[1].transpose(-2, -1)) * scale
    o = torch.softmax(s, dim=-1) @ t[2]
    return (o.transpose(1, 2).reshape(B, N, C).to(qkv.dtype),
            torch.logsumexp(s, dim=-1))


def fused_qkv_attention_plain(qkv: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    """The plain version's output alone."""
    return fused_qkv_attention_fwd_plain(qkv, num_heads, scale)[0]


def fused_qkv_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                  num_heads: int, scale: float) -> torch.Tensor:
    """The plain backward: the gradient of the plain version, in qkv's dtype."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        o = fused_qkv_attention_plain(x, num_heads, scale)
        (g,) = torch.autograd.grad(o, x, dout)
    return g


def _entry(name: str, t: torch.Tensor) -> str:
    """The C entry point `name` of the instance of t's dtype; other dtypes
    raise."""
    if t.dtype not in INSTANCES:
        raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float32, "
                        f"got {t.dtype}")
    return name + INSTANCES[t.dtype]


def _count(fn, t: torch.Tensor, dh: int | None = None) -> None:
    """One launch of `fn`'s instance of t's dtype (and head width dh)."""
    if t.dtype == torch.float32:
        fn.launches_f32 += 1
    else:
        fn.launches += 1
    if dh is not None:
        fn.launches_by_dh[t.dtype, dh] += 1


def _check_cuda(name: str, t: torch.Tensor, shape,
                dtype=torch.bfloat16) -> None:
    """t's dtype (the kernel instance's), shape, contiguity and alignment."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} here, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the CUDA kernel needs 16-byte alignment")


def _check_qkv(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    B, N, C, Dh = _split(qkv.shape, num_heads)
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for Dh in {HEAD_DIMS}, "
                         f"got {Dh}")
    if not 1 <= N <= MAX_FUSED_SEQ:
        raise ValueError(f"the CUDA kernel takes 1 <= N <= {MAX_FUSED_SEQ}, "
                         f"got {N}")
    _entry("qkv", qkv)
    _check_cuda("qkv", qkv, (B, N, 3 * C), qkv.dtype)
    return B, N, C, Dh


def attention_fwd(qkv: torch.Tensor, num_heads: int, scale: float):
    """Forward: (B, N, 3C) -> (out (B, N, C), lse (B, H, N) f32). Launches
    `attn_fwd` (bf16) or `attn_fwd_f32` on a CUDA tensor; the plain version
    on a CPU tensor."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_fwd_plain(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, N, C, Dh = _check_qkv(qkv, num_heads)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device)
    _build.launch_on(qkv.device, _entry("ssl4gie_attn_fwd", qkv),
                     qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, N,
                     num_heads, Dh, float(scale))
    _count(attention_fwd, qkv, Dh)
    return out, lse


attention_fwd.launches = attention_fwd.launches_f32 = 0
attention_fwd.launches_by_dh = collections.Counter()


def attention_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, num_heads: int,
                  scale: float) -> torch.Tensor:
    """Backward: (qkv (B, N, 3C), the forward's out (B, N, C) and lse
    (B, H, N), dO (B, N, C)) -> dqkv (B, N, 3C). Launches `attn_bwd_dq` then
    `attn_bwd_dkv` (or their f32 instances) on CUDA tensors; on CPU tensors
    the gradient of the plain version (which needs neither out nor lse)."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_bwd_plain(qkv, dout, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, N, C, Dh = _check_qkv(qkv, num_heads)
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != qkv.device:
            raise ValueError(f"{name} and qkv must be on one device")
    _check_cuda("out", out, (B, N, C), qkv.dtype)
    _check_cuda("dout", dout, (B, N, C), qkv.dtype)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, num_heads, N)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({B}, {num_heads}, {N}) "
                         "float32 tensor")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)          # scratch: rowsum(dO * O)
    _build.launch_on(qkv.device, _entry("ssl4gie_attn_bwd", qkv),
                     qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     dout.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, N,
                     num_heads, Dh, float(scale))
    _count(attention_bwd, qkv, Dh)
    return dqkv


attention_bwd.launches = attention_bwd.launches_f32 = 0
attention_bwd.launches_by_dh = collections.Counter()


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        out, lse = attention_fwd(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return attention_bwd(qkv, out, lse, dout.contiguous(), ctx.num_heads,
                             ctx.scale), None, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: float) -> torch.Tensor:
    """qkv: (B, N, 3*H*Dh) packed [all-q | all-k | all-v] -> (B, N, H*Dh).

    CUDA: the forward and backward kernels, through autograd. CPU: the plain
    version, differentiated by autograd."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, scale)
    return _FusedQKVAttention.apply(qkv, num_heads, scale)
