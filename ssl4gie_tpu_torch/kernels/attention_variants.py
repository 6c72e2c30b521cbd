"""The attention A/B variants of the JAX package's kernel harnesses.

Ports of the three Pallas kernels that live only in the JAX package's
benchmarks, each the same function as a production kernel with another
design:

- #10 `benchmarks/bench_attention_kernel.py:_mk_v2`: packed-QKV attention
  (the function of `dense_attention.fused_qkv_attention`) with Nb-row
  blocks (256, or 208 for the harness's "v3" legs) and G images a program.
  q is scaled in bf16 before Q.K^T, the unnormalised exponent is rounded to
  the input dtype for P.V and the division by the row sum is applied to the
  (N, Dh) output; the backward recomputes the softmax.
- #11 `bench_attention_kernel.py:_mk_v4` ("save-P"): the forward also
  returns the normalised softmax P in the input dtype, (B, H, N, Nb) with
  columns >= N zero, and the backward reads it instead of recomputing S:
  delta = rowsum(P * dP) from that P, dS = P (dP - delta), dQ, dK, dV.
- #12 `benchmarks/bench_window_kernel.py:_mk_v2`: windowed attention on the
  (B, GH, GW, 3C) grid (the function of `window_attention.
  windowed_flash_attention`) with #10's rounding points and G horizontally
  adjacent windows a program.

On a CUDA tensor each wrapper launches its hand-written kernel of
`csrc/attention_variants.cu` or `csrc/window_attention_v2.cu` (the resident
core of `csrc/attention_resident.cuh`: bf16, Dh = 64, N <= Nb, Nb in
{208, 256}, 208 for save-P; anything else raises). The forwards of all
three are one persistent kernel, `res_fwd_tma`, and their backwards another,
`res_bwd_tma` (dQ, dK and dV of a sequence in one pass; #11's instance
streams the saved P in 64 x 64 boxes and takes delta = rowsum(P * dP) from
it, with no scratch): each block takes every n-th (sequence, head) in an
order G sets (G adjacent sequences of one head together), loaded and stored
by TMA from a producer warpgroup, multiplied by two `wgmma` warpgroups. On
a CPU tensor it runs the plain PyTorch version below: the TPU kernel's
arithmetic at its rounding points, in the input dtype with float32 sums,
which is also what the kernels are checked against on the card. The TPU
kernels' pad handling (zeroed k and v rows, the analytic row-sum
correction) is not carried over: keys >= N are masked.

Each wrapper counts its launches (`launches`), so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels.dense_attention import HEAD_DIM, _check_cuda
from ssl4gie_tpu_torch.kernels.window_attention import (_dims, _lse_shape,
                                                        merge, partition)

BLOCK_ROWS = (208, 256)     # the Nb the resident kernels are built for
SAVE_P_ROWS = (208,)        # ... and the save-P kernels (the harness's)
MAX_SEQ = max(BLOCK_ROWS)


# ------------------------------------------------------------ plain versions
def _heads(x: torch.Tensor, num_heads: int, parts: int):
    """(B, N, parts * C) -> `parts` tensors (B, H, N, Dh)."""
    B, N, W = x.shape
    if W % (parts * num_heads) != 0:
        raise ValueError(f"width {W} is not {parts} * num_heads * Dh "
                         f"(num_heads={num_heads})")
    t = x.reshape(B, N, parts, num_heads, W // (parts * num_heads))
    return t.permute(2, 0, 3, 1, 4).unbind(0)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, Dh) -> (B, N, H * Dh)."""
    B, H, N, Dh = t.shape
    return t.transpose(1, 2).reshape(B, N, H * Dh)


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, the scale rounded to it first (the TPU
    kernels' `q * jnp.asarray(scale, dt)`)."""
    s = torch.tensor(scale, dtype=q.dtype).float()
    return (q.float() * s).to(q.dtype)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T of input-dtype operands with float32 sums."""
    return a.float() @ b.float().transpose(-2, -1)


def _softmax_parts(qkv: torch.Tensor, num_heads: int, scale: float):
    """q scaled, k, v (B, H, N, Dh) and the unnormalised exponent e = exp(s -
    max s) of the scaled scores with its float32 row sum l and max m."""
    q, k, v = _heads(qkv, num_heads, 3)
    qs = _scaled_q(q, scale)
    s = _dot(qs, k)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return qs, k, v, e, e.sum(-1, keepdim=True), m


def packed_attention_v2_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                  scale: float):
    """#10's forward: (B, N, 3C) -> (out (B, N, C), lse (B, H, N) f32). The
    exponent rounded to the input dtype for P.V, then divided by the row
    sum."""
    _, _, v, e, l, m = _softmax_parts(qkv, num_heads, scale)
    o = (e.to(qkv.dtype).float() @ v.float()) / l
    return (_merge_heads(o).to(qkv.dtype),
            (m + torch.log(l)).squeeze(-1))


def _grads(qs, k, v, do, p, pb, scale, dtype):
    """The backward shared by #10 and #11 from float32 P and its rounding
    pb: delta = rowsum(P * dP), dS = P (dP - delta) in the input dtype;
    dq = dS.K scale, dk = dS^T.qs, dv = pb^T.dO, packed (B, N, 3C)."""
    dp = _dot(do, v)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(dtype)
    dq = (ds.float() @ k.float()) * scale
    dk = ds.float().transpose(-2, -1) @ qs.float()
    dv = pb.float().transpose(-2, -1) @ do.float()
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)], -1).to(dtype)


def packed_attention_v2_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                  num_heads: int,
                                  scale: float) -> torch.Tensor:
    """#10's backward: the softmax recomputed, P = e / l in float32."""
    qs, k, v, e, l, _ = _softmax_parts(qkv, num_heads, scale)
    (do,) = _heads(dout, num_heads, 1)
    p = e / l
    return _grads(qs, k, v, do, p, p.to(qkv.dtype), scale, qkv.dtype)


def packed_attention_save_p_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                      scale: float, block: int = 208):
    """#11's forward: (out (B, N, C), P (B, H, N, block)). P = e / l rounded
    to the input dtype, then P.V; P's columns >= N are zero."""
    N = qkv.shape[1]
    if N > block:
        raise ValueError(f"N={N} does not fit a block of {block} rows")
    _, _, v, e, l, _ = _softmax_parts(qkv, num_heads, scale)
    pb = (e / l).to(qkv.dtype)
    o = _merge_heads(pb.float() @ v.float()).to(qkv.dtype)
    return o, torch.nn.functional.pad(pb, (0, block - N))


def packed_attention_save_p_bwd_plain(qkv: torch.Tensor, p: torch.Tensor,
                                      dout: torch.Tensor, num_heads: int,
                                      scale: float) -> torch.Tensor:
    """#11's backward from the saved P: no S, no exponent."""
    N = qkv.shape[1]
    q, k, v = _heads(qkv, num_heads, 3)
    (do,) = _heads(dout, num_heads, 1)
    pb = p[..., :N]
    return _grads(_scaled_q(q, scale), k, v, do, pb.float(), pb, scale,
                  qkv.dtype)


def window_attention_v2_fwd_plain(qkv: torch.Tensor, num_heads: int,
                                  window: int, scale: float):
    """#12's forward: window partition, #10's forward, merge. Returns out
    (B, GH, GW, C) and lse (B * nh * nw, H, ws * ws)."""
    B, GH, GW, _ = _dims(qkv.shape, num_heads, window)
    out, lse = packed_attention_v2_fwd_plain(partition(qkv, window),
                                             num_heads, scale)
    return merge(out, B, GH, GW, window), lse


def window_attention_v2_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                  num_heads: int, window: int,
                                  scale: float) -> torch.Tensor:
    """#12's backward: #10's on the partitioned windows, merged."""
    B, GH, GW, _ = _dims(qkv.shape, num_heads, window)
    g = packed_attention_v2_bwd_plain(partition(qkv, window),
                                      partition(dout, window), num_heads,
                                      scale)
    return merge(g, B, GH, GW, window)


# ------------------------------------------------------------ wrappers
def _check_dense(qkv: torch.Tensor, num_heads: int, block: int,
                 blocks=BLOCK_ROWS):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3C), got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    if C3 % (3 * num_heads) or C3 // (3 * num_heads) != HEAD_DIM:
        raise ValueError(f"the CUDA kernels are built for Dh={HEAD_DIM}, got "
                         f"width {C3} with {num_heads} heads")
    if block not in blocks:
        raise ValueError(f"the CUDA kernels are built for Nb in {blocks}, "
                         f"got {block}")
    if not 1 <= N <= block:
        raise ValueError(f"the CUDA kernels take 1 <= N <= Nb={block}, "
                         f"got {N}")
    _check_cuda("qkv", qkv, (B, N, C3))
    return B, N, C3 // 3


def _check_group(G: int) -> int:
    if int(G) < 1:
        raise ValueError(f"G must be at least 1, got {G}")
    return int(G)


def _check_same(qkv: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != qkv.device:
            raise ValueError(f"{name} and qkv must be on one device")


def _check_stats(name: str, t: torch.Tensor, shape) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         "float32 tensor")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def attention_v2_fwd(qkv: torch.Tensor, num_heads: int, scale: float,
                     G: int = 2, block: int = 256):
    """#10's forward: (B, N, 3C) -> (out (B, N, C), lse (B, H, N) f32).
    Launches `res_fwd_tma` (G images of one head adjacent in its order) on
    a CUDA tensor; the plain version on a CPU tensor."""
    if not _on_cuda(qkv):
        return packed_attention_v2_fwd_plain(qkv, num_heads, scale)
    B, N, C = _check_dense(qkv, num_heads, block)
    G = _check_group(G)
    out = qkv.new_empty((B, N, C))
    lse = torch.empty((B, num_heads, N), dtype=torch.float32,
                      device=qkv.device)
    _build.launch_on(qkv.device, "ssl4gie_attn_v2_fwd", qkv.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, N, num_heads, block, G,
                     float(scale))
    attention_v2_fwd.launches += 1
    return out, lse


attention_v2_fwd.launches = 0


def attention_v2_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                     dout: torch.Tensor, num_heads: int, scale: float,
                     G: int = 2, block: int = 256) -> torch.Tensor:
    """#10's backward: (qkv, the forward's out and lse, dO) -> dqkv
    (B, N, 3C). Launches `res_bwd_tma` (G images of one head adjacent in
    its order) on CUDA tensors; on CPU tensors the plain backward (which
    needs neither out nor lse)."""
    if not _on_cuda(qkv):
        return packed_attention_v2_bwd_plain(qkv, dout, num_heads, scale)
    B, N, C = _check_dense(qkv, num_heads, block)
    G = _check_group(G)
    _check_same(qkv, out=out, lse=lse, dout=dout)
    _check_cuda("out", out, (B, N, C))
    _check_cuda("dout", dout, (B, N, C))
    _check_stats("lse", lse, (B, num_heads, N))
    dqkv = torch.empty_like(qkv)
    _build.launch_on(qkv.device, "ssl4gie_attn_v2_bwd", qkv.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                     dqkv.data_ptr(), B, N, num_heads, block, G, float(scale))
    attention_v2_bwd.launches += 1
    return dqkv


attention_v2_bwd.launches = 0


def attention_save_p_fwd(qkv: torch.Tensor, num_heads: int, scale: float,
                         G: int = 2, block: int = 208):
    """#11's forward: (B, N, 3C) -> (out (B, N, C), P (B, H, N, block) in
    qkv's dtype). Launches `res_fwd_tma`'s save-P instance (P stored by
    TMA) on a CUDA tensor; the plain version on a CPU tensor."""
    if not _on_cuda(qkv):
        return packed_attention_save_p_fwd_plain(qkv, num_heads, scale, block)
    B, N, C = _check_dense(qkv, num_heads, block, SAVE_P_ROWS)
    G = _check_group(G)
    out = qkv.new_empty((B, N, C))
    p = qkv.new_empty((B, num_heads, N, block))
    _build.launch_on(qkv.device, "ssl4gie_attn_savep_fwd", qkv.data_ptr(),
                     out.data_ptr(), p.data_ptr(), B, N, num_heads, block, G,
                     float(scale))
    attention_save_p_fwd.launches += 1
    return out, p


attention_save_p_fwd.launches = 0


def attention_save_p_bwd(qkv: torch.Tensor, p: torch.Tensor,
                         dout: torch.Tensor, num_heads: int, scale: float,
                         G: int = 2) -> torch.Tensor:
    """#11's backward: (qkv, the forward's P, dO) -> dqkv (B, N, 3C).
    Launches `res_bwd_tma`'s save-P instance on CUDA tensors (one kernel:
    delta = rowsum(P * dP) in shared memory, P's columns >= N ignored); the
    plain backward on CPU tensors."""
    if not _on_cuda(qkv):
        return packed_attention_save_p_bwd_plain(qkv, p, dout, num_heads,
                                                 scale)
    block = p.shape[-1]
    B, N, C = _check_dense(qkv, num_heads, block, SAVE_P_ROWS)
    G = _check_group(G)
    _check_same(qkv, p=p, dout=dout)
    _check_cuda("p", p, (B, num_heads, N, block))
    _check_cuda("dout", dout, (B, N, C))
    dqkv = torch.empty_like(qkv)
    _build.launch_on(qkv.device, "ssl4gie_attn_savep_bwd", qkv.data_ptr(),
                     p.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), B, N,
                     num_heads, block, G, float(scale))
    attention_save_p_bwd.launches += 1
    return dqkv


attention_save_p_bwd.launches = 0


def _check_window(qkv: torch.Tensor, num_heads: int, window: int, G: int):
    B, GH, GW, C = _dims(qkv.shape, num_heads, window)
    if C // num_heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernels are built for Dh={HEAD_DIM}, "
                         f"got {C // num_heads}")
    if window * window > MAX_SEQ:
        raise ValueError(f"the CUDA kernels take windows of at most {MAX_SEQ} "
                         f"tokens, got {window}x{window}")
    if (GW // window) % _check_group(G):
        raise ValueError(f"G={G} does not divide the {GW // window} windows "
                         "of a grid row")
    _check_cuda("qkv", qkv, (B, GH, GW, 3 * C))
    return B, GH, GW, C


def window_v2_fwd(qkv: torch.Tensor, num_heads: int, window: int,
                  scale: float, G: int = 1):
    """#12's forward: (B, GH, GW, 3C) -> (out (B, GH, GW, C), lse f32).
    Launches `res_fwd_tma` (G adjacent windows of one head adjacent in its
    order) on a CUDA tensor; the plain version on a CPU tensor."""
    if not _on_cuda(qkv):
        return window_attention_v2_fwd_plain(qkv, num_heads, window, scale)
    B, GH, GW, C = _check_window(qkv, num_heads, window, G)
    out = qkv.new_empty((B, GH, GW, C))
    lse = torch.empty(_lse_shape(B, GH, GW, num_heads, window),
                      dtype=torch.float32, device=qkv.device)
    _build.launch_on(qkv.device, "ssl4gie_window_attn_v2_fwd", qkv.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, GH, GW, window,
                     num_heads, int(G), float(scale))
    window_v2_fwd.launches += 1
    return out, lse


window_v2_fwd.launches = 0


def window_v2_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, num_heads: int, window: int,
                  scale: float, G: int = 1) -> torch.Tensor:
    """#12's backward: (qkv, the forward's out and lse, dO (B, GH, GW, C))
    -> dqkv (B, GH, GW, 3C). Launches `res_bwd_tma` (G adjacent windows of
    one head adjacent in its order) on CUDA tensors; the plain backward on
    CPU tensors."""
    if not _on_cuda(qkv):
        return window_attention_v2_bwd_plain(qkv, dout, num_heads, window,
                                             scale)
    B, GH, GW, C = _check_window(qkv, num_heads, window, G)
    _check_same(qkv, out=out, lse=lse, dout=dout)
    _check_cuda("out", out, (B, GH, GW, C))
    _check_cuda("dout", dout, (B, GH, GW, C))
    _check_stats("lse", lse, _lse_shape(B, GH, GW, num_heads, window))
    dqkv = torch.empty_like(qkv)
    _build.launch_on(qkv.device, "ssl4gie_window_attn_v2_bwd", qkv.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                     dqkv.data_ptr(), B, GH, GW, window, num_heads, int(G),
                     float(scale))
    window_v2_bwd.launches += 1
    return dqkv


window_v2_bwd.launches = 0


# ------------------------------------------------------------ autograd
class _PackedV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale, fwd_G, bwd_G, block):
        out, lse = attention_v2_fwd(qkv, num_heads, scale, fwd_G, block)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, scale, bwd_G, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        num_heads, scale, G, block = ctx.args
        return (attention_v2_bwd(qkv, out, lse, dout.contiguous(), num_heads,
                                 scale, G, block),) + (None,) * 5


class _PackedSaveP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale, fwd_G, bwd_G, block):
        out, p = attention_save_p_fwd(qkv, num_heads, scale, fwd_G, block)
        ctx.save_for_backward(qkv, p)
        ctx.args = (num_heads, scale, bwd_G)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, p = ctx.saved_tensors
        num_heads, scale, G = ctx.args
        return (attention_save_p_bwd(qkv, p, dout.contiguous(), num_heads,
                                     scale, G),) + (None,) * 5


class _WindowV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, window, scale, G):
        out, lse = window_v2_fwd(qkv, num_heads, window, scale, G)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, window, scale, G)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return (window_v2_bwd(qkv, out, lse, dout.contiguous(), *ctx.args),
                None, None, None, None)


def _group(batch: int, G: int) -> int:
    """The TPU harness's rule: G images a program if they divide the batch,
    else one."""
    return G if batch % G == 0 else 1


def packed_attention_v2(qkv: torch.Tensor, num_heads: int, scale: float,
                        fwd_G: int = 2, bwd_G: int = 2,
                        Nb: int = 256) -> torch.Tensor:
    """#10: qkv (B, N, 3*H*Dh) packed [all-q | all-k | all-v] -> (B, N,
    H*Dh), through autograd. CUDA: the kernels; CPU: the plain versions."""
    B = qkv.shape[0]
    return _PackedV2.apply(qkv, num_heads, scale, _group(B, fwd_G),
                           _group(B, bwd_G), Nb)


def packed_attention_save_p(qkv: torch.Tensor, num_heads: int, scale: float,
                            fwd_G: int = 2, bwd_G: int = 2,
                            Nb: int = 208) -> torch.Tensor:
    """#11: as packed_attention_v2, the softmax P saved by the forward for
    the backward."""
    B = qkv.shape[0]
    return _PackedSaveP.apply(qkv, num_heads, scale, _group(B, fwd_G),
                              _group(B, bwd_G), Nb)


def window_attention_v2(qkv: torch.Tensor, num_heads: int, window: int,
                        scale: float, G: int = 1) -> torch.Tensor:
    """#12: qkv (B, GH, GW, 3C) grid layout -> (B, GH, GW, C), G adjacent
    windows a block, through autograd. CUDA: the kernels; CPU: the plain
    versions."""
    GW = _dims(qkv.shape, num_heads, window)[2]
    if (GW // window) % _check_group(G):
        raise ValueError(f"G={G} does not divide the {GW // window} windows "
                         "of a grid row")
    return _WindowV2.apply(qkv, num_heads, window, scale, G)
