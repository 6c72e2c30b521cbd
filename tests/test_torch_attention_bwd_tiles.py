"""The arithmetic of the port's attention backward
(`ssl4gie_tpu_torch/csrc/attention_core.cuh:attn_bwd_dq` and
`attn_bwd_dkv`), emulated in torch on the CPU: the CUDA kernels themselves
run only on the card (the `gpu`-marked tests in `test_torch_kernels.py` and
`chip_smoke.py`).

The emulation walks the tiles as the two kernels do. The dq kernel: delta =
rowsum(dO * O) in float32, then 64-key tiles up to the last that holds a key
< n_valid, with P = exp2(fma(S, scale * log2(e), -lse * log2(e))) from the
forward's saved log-sum-exp, keys >= n_valid at p = 0 before the exponent,
dS = P (dP - delta) rounded to bf16 before dS.K, and the scale applied to dQ
at the end. The dk/dv kernel: 64-query tiles over the whole sequence, rows
past the end zero-filled with their p set to 0 by index, bf16(P^T).dO and
bf16(dS^T).Q, keys >= n_valid at p = 0, the scale applied to dK at the end.
The inputs o and lse come from the emulated forward of
`test_torch_online_softmax.py`, as on the card they come from the forward
kernel. It is held against the JAX package's backward kernels in interpret
mode (`jax.vjp` of `fused_qkv_attention`, `windowed_flash_attention` and
`flash_attention`) and against the port's plain backwards, at the card
checks' tolerance: two bf16 ulps (2^-6) of the element or of the largest
element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import window_attention as wa
from test_torch_online_softmax import (KEY_TILE, LOG2E, OUT_TOL, assert_close,
                                       bf16, bf16_values, heads, merge_heads,
                                       online_softmax_fwd)

torch.set_num_threads(1)


def fma_exp2(s, sl2, nl):
    """exp2(fma(s, sl2, nl)) in float32: the product is exact in float64,
    so the sum rounds once, as the kernels' fmaf does."""
    return torch.exp2((s.double() * sl2 + nl.double()).float())


def pad_rows(x: torch.Tensor, n: int, fill=0.0) -> torch.Tensor:
    """(S, N, ...) -> (S, n, ...), rows >= N set to `fill` (the kernels'
    zero-filled copies past the end of the sequence)."""
    pad = torch.full((x.shape[0], n - x.shape[1], *x.shape[2:]), fill)
    return torch.cat([x, pad], dim=1)


def bwd_tiles(q, k, v, o, lse, do, scale: float, n_valid=None):
    """q, k, v, o, do (S, N, D) float32 holding bf16 values, lse (S, N)
    float32 -> (dq, dk, dv) (S, N, D) float32 holding bf16 values, by the
    two kernels' tile loops."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    NP = -(-N // KEY_TILE) * KEY_TILE                # whole 64-row tiles
    sl2 = float(np.float32(np.float32(scale) * np.float32(LOG2E)))
    nl = -lse * np.float32(LOG2E)
    delta = (do * o).sum(-1)
    keys = torch.arange(NP)
    # keys >= n_valid and rows >= N are zero-filled by the copies
    k, v = (torch.where((keys < n)[:, None], pad_rows(x, NP), 0.0)
            for x in (k, v))
    q, do = pad_rows(q, NP), pad_rows(do, NP)

    # dq: query rows >= N take lse = +inf; the loop stops at the last tile
    # that holds a key < n_valid
    nl_q = pad_rows(nl, NP, -torch.inf)[..., None]
    dl_q = pad_rows(delta, NP)[..., None]
    dq = torch.zeros((S, NP, D))
    for t0 in range(0, n, KEY_TILE):
        kt, vt = k[:, t0:t0 + KEY_TILE], v[:, t0:t0 + KEY_TILE]
        s = torch.where(keys[t0:t0 + KEY_TILE] < n, q @ kt.transpose(1, 2),
                        -torch.inf)
        p = fma_exp2(s, sl2, nl_q)
        ds = bf16(p * (do @ vt.transpose(1, 2) - dl_q))
        dq = dq + ds @ kt
    assert bool(torch.isfinite(dq).all())

    # dk, dv: each tile's lse and delta are zero-filled past N, and those
    # query columns get p = 0 by index; keys >= n_valid get p = 0
    nl_t, dl_t = pad_rows(nl, NP)[:, None, :], pad_rows(delta, NP)[:, None, :]
    dk, dv = torch.zeros((S, NP, D)), torch.zeros((S, NP, D))
    for t0 in range(0, NP, KEY_TILE):
        cols = slice(t0, t0 + KEY_TILE)
        st = k @ q[:, cols].transpose(1, 2)                  # (S, keys, queries)
        ok = (keys < n)[:, None] & (keys[cols] < N)[None, :]
        p = fma_exp2(torch.where(ok, st, -torch.inf), sl2, nl_t[..., cols])
        dv = dv + bf16(p) @ do[:, cols]
        dpt = v @ do[:, cols].transpose(1, 2)
        dk = dk + bf16(p * (dpt - dl_t[..., cols])) @ q[:, cols]
    assert bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())
    return (bf16(dq[:, :N] * scale), bf16(dk[:, :N] * scale),
            bf16(dv[:, :N]))


def packed_bwd_tiles(qkv, dout, num_heads: int, scale: float):
    """(S, N, 3C) packed qkv and dO (S, N, C) -> dqkv (S, N, 3C), through
    the emulated forward and backward."""
    S = qkv.shape[0]
    q, k, v = heads(qkv, num_heads)
    o, lse = online_softmax_fwd(q, k, v, scale)
    grads = bwd_tiles(q, k, v, o, lse, heads_of_c(dout, num_heads), scale)
    return torch.cat([merge_heads(g, S, num_heads) for g in grads], dim=-1)


def heads_of_c(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(S, N, C) -> (S * H, N, Dh)."""
    S, N, C = x.shape
    dh = C // num_heads
    return x.reshape(S, N, num_heads, dh).transpose(1, 2).reshape(
        S * num_heads, N, dh)


def jax_vjp(fn, args, dout, dtype):
    """The gradient of fn at args against dout, in interpret mode, with the
    operands in `dtype`; float32 numpy arrays out."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in args))
        grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dh", [32, 64])
def test_bwd_tiles_match_dense_kernel(dh):
    """N = 197 (a partial last tile of 5 rows in both loops): the
    packed-QKV layout, against `jax.vjp` of `fused_qkv_attention` (bf16, as
    on the model's path) and the port's plain backward (float32)."""
    from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention
    B, N, H = 2, 197, 2
    scale = dh ** -0.5
    rng = np.random.default_rng(40 + dh)
    qkv = bf16_values(rng, (B, N, 3 * H * dh))
    dout = bf16_values(rng, (B, N, H * dh))
    got = packed_bwd_tiles(torch.from_numpy(qkv), torch.from_numpy(dout), H,
                           scale)
    (ref,) = jax_vjp(lambda x: fused_qkv_attention(x, H, scale), (qkv,), dout,
                     jnp.bfloat16)
    assert_close(got, ref, OUT_TOL, "vs Pallas")
    assert_close(got, da.fused_qkv_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(dout), H, scale), OUT_TOL,
        "vs plain")


@pytest.mark.parametrize("dh", [32, 64])
def test_bwd_tiles_match_window_kernel(dh):
    """A 16 x 16 window (256 rows, four whole tiles) on a 32 x 32 grid:
    against `jax.vjp` of `windowed_flash_attention` (bf16) and the port's
    plain backward (float32)."""
    from ssl4gie_tpu.kernels.window_attention import windowed_flash_attention
    H, window = 2, 16
    scale = dh ** -0.5
    rng = np.random.default_rng(50 + dh)
    grid = bf16_values(rng, (1, 32, 32, 3 * H * dh))
    dout = bf16_values(rng, (1, 32, 32, H * dh))
    x = wa.partition(torch.from_numpy(grid), window)          # (4, 256, 3C)
    g = packed_bwd_tiles(x, wa.partition(torch.from_numpy(dout), window), H,
                         scale)
    got = wa.merge(g, 1, 32, 32, window)
    (ref,) = jax_vjp(
        lambda a: windowed_flash_attention(a, H, window, scale), (grid,), dout,
        jnp.bfloat16)
    assert_close(got, ref, OUT_TOL, "vs Pallas")
    assert_close(got, wa.windowed_attention_bwd_plain(
        torch.from_numpy(grid), torch.from_numpy(dout), H, window, scale),
        OUT_TOL, "vs plain")


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("case", ["full", "n_valid=3", "partial", "low_lse"])
def test_bwd_tiles_match_flash_kernel(dh, case):
    """The flash layout at N = 256: all keys; n_valid = 3 (the dq loop
    visits one tile); n_valid = 197 (a partial last key tile); and n_valid =
    197 with one row whose valid logits are spread below -87 (lse about
    -315, so exp(-lse) would overflow for a padded key). Against `jax.vjp`
    of `flash_attention` on float32 operands that hold the bf16 values (its
    dq and, for keys < n_valid, dk and dv: its dk/dv kernel does not mask
    padded keys, whose gradients the caller drops) and the port's plain
    backward (float32), whose masked keys get zero gradients, as the
    emulation's must. float32, because JAX's CPU dot of bf16 operands does
    not sum exactly in float32 and the low-lse row's gradient is sensitive
    to the lse (see test_torch_online_softmax.py)."""
    from ssl4gie_tpu.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(60 + dh)
    q, k, v, dout = (bf16_values(rng, (2, 256, dh)) for _ in range(4))
    n_valid = {"full": None, "n_valid=3": 3, "partial": 197,
               "low_lse": 197}[case]
    if case == "low_lse":
        q[0, 0] = 40.0
        k[0] = bf16(torch.from_numpy(-1.0 + 0.01 * k[0])).numpy()
    scale = dh ** -0.5
    qt, kt, vt, dt = map(torch.from_numpy, (q, k, v, dout))
    o, lse = online_softmax_fwd(qt, kt, vt, scale, n_valid)
    if case == "low_lse":
        assert float(lse[0, 0]) < -87.0
    got = bwd_tiles(qt, kt, vt, o, lse, dt, scale, n_valid)
    n = 256 if n_valid is None else n_valid
    for g in got[1:]:
        assert bool((g[:, n:] == 0).all())           # masked keys: zero
    ref = jax_vjp(lambda a, b, c: flash_attention(a, b, c, scale, n_valid),
                  (q, k, v), dout, jnp.float32)
    assert_close(got[0], ref[0], OUT_TOL, "dq vs Pallas")
    for g, r, name in zip(got[1:], ref[1:], "kv"):
        assert_close(g[:, :n], r[:, :n], OUT_TOL, f"d{name} vs Pallas")
    for g, r, name in zip(got, fa.flash_attention_bwd_plain(
            qt, kt, vt, dt, scale, n_valid), "qkv"):
        assert_close(g, r, OUT_TOL, f"d{name} vs plain")
