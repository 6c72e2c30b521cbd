"""Windowed multi-head attention on the (B, GH, GW, 3C) packed-qkv grid.

Port of `ssl4gie_tpu/kernels/window_attention.py:windowed_flash_attention`.
Each ws x ws window of the grid is one attention sequence; the output is
(B, GH, GW, C) in grid layout. The forward also returns each window row's
log-sum-exp (B * nh * nw, H, ws * ws); the backward reads it with the saved
output and returns a packed dqkv (B, GH, GW, 3C).

On a CUDA tensor the forward and backward run the hand-written kernels of
`csrc/window_attention.cu`, which read and write the grid in place (Dh =
64, ws * ws <= 512; the bf16 or the float32 instance by the tensor's dtype,
counted apart as `launches` and `launches_f32`; anything else raises). On a
CPU tensor they run the
plain PyTorch version below (window partition, then the dense kernel's plain
version), which is also what the kernels are checked against on the card.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels.dense_attention import (
    HEAD_DIM, MAX_FUSED_SEQ, _check_cuda, _count, _entry,
    fused_qkv_attention_fwd_plain)


def _dims(shape, num_heads: int, window: int):
    if len(shape) != 4:
        raise ValueError(f"qkv must be (B, GH, GW, 3C), got {tuple(shape)}")
    B, GH, GW, C3 = shape
    if C3 % (3 * num_heads) != 0:
        raise ValueError(f"qkv width {C3} is not 3 * num_heads * Dh "
                         f"(num_heads={num_heads})")
    if GH % window or GW % window:
        raise ValueError(f"grid {GH}x{GW} is not a multiple of window {window}")
    return B, GH, GW, C3 // 3


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, GH, GW, W) -> (B * nh * nw, ws * ws, W), windows row-major."""
    B, GH, GW, W = x.shape
    nh, nw = GH // window, GW // window
    x = x.reshape(B, nh, window, nw, window, W).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * nh * nw, window * window, W)


def merge(x: torch.Tensor, B: int, GH: int, GW: int, window: int) -> torch.Tensor:
    """The inverse of `partition`."""
    nh, nw = GH // window, GW // window
    x = x.reshape(B, nh, nw, window, window, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, GH, GW, -1)


def windowed_attention_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                 window: int, scale: float):
    """The plain version: window partition, head-split softmax attention in
    f32, merge. Returns the output in the input dtype and the f32
    log-sum-exp (B * nh * nw, H, ws * ws). Differentiable through autograd."""
    B, GH, GW, _ = _dims(qkv.shape, num_heads, window)
    out, lse = fused_qkv_attention_fwd_plain(partition(qkv, window), num_heads,
                                             scale)
    return merge(out, B, GH, GW, window), lse


def windowed_attention_plain(qkv: torch.Tensor, num_heads: int, window: int,
                             scale: float) -> torch.Tensor:
    """The plain version's output alone."""
    return windowed_attention_fwd_plain(qkv, num_heads, window, scale)[0]


def windowed_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                 num_heads: int, window: int,
                                 scale: float) -> torch.Tensor:
    """The plain backward: the gradient of the plain version, in qkv's dtype."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        o = windowed_attention_plain(x, num_heads, window, scale)
        (g,) = torch.autograd.grad(o, x, dout)
    return g


def _check_qkv(qkv: torch.Tensor, num_heads: int, window: int):
    B, GH, GW, C = _dims(qkv.shape, num_heads, window)
    if C // num_heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for Dh={HEAD_DIM}, "
                         f"got {C // num_heads}")
    if window * window > MAX_FUSED_SEQ:
        raise ValueError(f"the CUDA kernel takes windows of at most "
                         f"{MAX_FUSED_SEQ} tokens, got {window}x{window}")
    _entry("qkv", qkv)
    _check_cuda("qkv", qkv, (B, GH, GW, 3 * C), qkv.dtype)
    return B, GH, GW, C


def _lse_shape(B, GH, GW, num_heads, window):
    return (B * (GH // window) * (GW // window), num_heads, window * window)


def window_attention_fwd(qkv: torch.Tensor, num_heads: int, window: int,
                         scale: float):
    """Forward: (B, GH, GW, 3C) -> (out (B, GH, GW, C), lse f32). Launches
    `attn_fwd` over the windows on a CUDA tensor; the plain version on a CPU
    tensor."""
    if qkv.device.type == "cpu":
        return windowed_attention_fwd_plain(qkv, num_heads, window, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, GH, GW, C = _check_qkv(qkv, num_heads, window)
    out = torch.empty((B, GH, GW, C), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(_lse_shape(B, GH, GW, num_heads, window),
                      dtype=torch.float32, device=qkv.device)
    _build.launch_on(qkv.device, _entry("ssl4gie_window_attn_fwd", qkv),
                     qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), B, GH, GW,
                     window, num_heads, float(scale))
    _count(window_attention_fwd, qkv)
    return out, lse


window_attention_fwd.launches = window_attention_fwd.launches_f32 = 0


def window_attention_bwd(qkv: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
                         window: int, scale: float) -> torch.Tensor:
    """Backward: (qkv, the forward's out and lse, dO (B, GH, GW, C)) ->
    dqkv (B, GH, GW, 3C). Launches `attn_bwd_dq` then `attn_bwd_dkv` over the
    windows on CUDA tensors; on CPU tensors the gradient of the plain
    version (which needs neither out nor lse)."""
    if qkv.device.type == "cpu":
        return windowed_attention_bwd_plain(qkv, dout, num_heads, window,
                                            scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    B, GH, GW, C = _check_qkv(qkv, num_heads, window)
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != qkv.device:
            raise ValueError(f"{name} and qkv must be on one device")
    _check_cuda("out", out, (B, GH, GW, C), qkv.dtype)
    _check_cuda("dout", dout, (B, GH, GW, C), qkv.dtype)
    shape = _lse_shape(B, GH, GW, num_heads, window)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != shape
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous {shape} float32 tensor")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)          # scratch: rowsum(dO * O)
    _build.launch_on(qkv.device, _entry("ssl4gie_window_attn_bwd", qkv),
                     qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     dout.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, GH,
                     GW, window, num_heads, float(scale))
    _count(window_attention_bwd, qkv)
    return dqkv


window_attention_bwd.launches = window_attention_bwd.launches_f32 = 0


class _WindowedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, window, scale):
        out, lse = window_attention_fwd(qkv, num_heads, window, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return (window_attention_bwd(qkv, out, lse, dout.contiguous(),
                                     *ctx.args), None, None, None)


def windowed_flash_attention(qkv: torch.Tensor, num_heads: int, window: int,
                             scale: float) -> torch.Tensor:
    """qkv: (B, GH, GW, 3C) grid layout -> (B, GH, GW, C).

    CUDA: the forward and backward kernels, through autograd. CPU: the plain
    version, differentiated by autograd."""
    if qkv.device.type == "cpu":
        return windowed_attention_plain(qkv, num_heads, window, scale)
    return _WindowedAttention.apply(qkv, num_heads, window, scale)
