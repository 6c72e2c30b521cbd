"""The arithmetic of the port's online-softmax attention forward
(`ssl4gie_tpu_torch/csrc/attention_core.cuh:attn_fwd`), emulated in torch on
the CPU: the CUDA kernel itself runs only on the card (the `gpu`-marked tests
in `test_torch_kernels.py` and `chip_smoke.py`).

The emulation walks the keys in tiles of 64 as the kernel does: scores in
float32, the log2 domain with scale * log2(e) folded into one FMA, a running
row max and a per-tile rescale of the row sum and the output, the
unnormalised probabilities rounded to bf16 before the product with V, the
output divided by the row sum and rounded to bf16 at the end, and the
natural-log log-sum-exp m * scale + ln(l). It is held against the JAX
package's forward kernels in interpret mode (bf16 in and out, as on the
model's path) and against the port's plain versions (float32 softmax), at
the card checks' tolerances: two bf16 ulps (2^-6) of the element or of the
largest element for the output, 2^-16 for the log-sum-exp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import window_attention as wa

torch.set_num_threads(1)

KEY_TILE = 64                    # csrc/attention_core.cuh: kKeys
LOG2E = 1.4426950408889634
OUT_TOL, LSE_TOL = 2.0 ** -6, 2.0 ** -16


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def online_softmax_fwd(q, k, v, scale: float, n_valid=None):
    """q, k, v (S, N, D) float32 holding bf16 values -> (o (S, N, D) float32
    holding bf16 values, lse (S, N) float32), by the kernel's tile loop."""
    S, N, D = q.shape
    n = N if n_valid is None else n_valid
    sl2 = np.float32(scale * LOG2E)
    m = torch.full((S, N), -torch.inf)
    l = torch.zeros((S, N))
    acc = torch.zeros((S, N, D))
    for t0 in range(0, n, KEY_TILE):             # stops at the last valid tile
        kt, vt = k[:, t0:t0 + KEY_TILE], v[:, t0:t0 + KEY_TILE]
        s = q @ kt.transpose(1, 2)
        keys = torch.arange(t0, t0 + kt.shape[1])
        s = torch.where(keys < n, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * sl2)          # 0 on the first tile
        ms = (mx * sl2)[..., None]
        # fma(s, sl2, -ms): the product is exact in float64, one rounding
        p = torch.exp2((s.double() * float(sl2) - ms.double()).float())
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + bf16(p) @ vt
        m = mx
    return bf16(acc / l[..., None]), m * scale + torch.log(l)


def assert_close(got, ref, tol, what):
    """Every element within tol * (|ref| + max|ref|), all finite."""
    got, ref = (torch.as_tensor(np.array(x)).float() for x in (got, ref))
    assert bool(torch.isfinite(got).all()), what
    err = (got - ref).abs()
    bound = tol * (ref.abs() + ref.abs().max())
    assert bool((err <= bound).all()), (what, err.max().item(),
                                        ref.abs().max().item())


def bf16_values(rng, shape) -> np.ndarray:
    """Normal draws rounded to bf16, as float32."""
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return bf16(x).numpy()


def heads(x: torch.Tensor, num_heads: int) -> list[torch.Tensor]:
    """(S, N, 3C) packed qkv -> q, k, v (S * H, N, Dh)."""
    S, N, C3 = x.shape
    dh = C3 // 3 // num_heads
    t = x.reshape(S, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return [a.reshape(S * num_heads, N, dh) for a in t]


def merge_heads(o: torch.Tensor, S: int, num_heads: int) -> torch.Tensor:
    """(S * H, N, Dh) -> (S, N, H * Dh)."""
    _, N, dh = o.shape
    return o.reshape(S, num_heads, N, dh).transpose(1, 2).reshape(S, N, -1)


@pytest.mark.parametrize("dh", [32, 64])
def test_online_softmax_matches_dense_kernel(dh):
    """N = 197 (a partial last tile of 5 keys): the packed-QKV layout,
    against `dense_attention._fused_fwd` and the port's plain version."""
    from ssl4gie_tpu.kernels.dense_attention import _fused_fwd
    B, N, H = 2, 197, 2
    scale = dh ** -0.5
    qkv = bf16_values(np.random.default_rng(10 + dh), (B, N, 3 * H * dh))
    with pltpu.force_tpu_interpret_mode():
        ref = _fused_fwd(jnp.asarray(qkv, jnp.bfloat16), H, scale)
    ref = np.asarray(ref.astype(jnp.float32))
    o, lse = online_softmax_fwd(*heads(torch.from_numpy(qkv), H), scale)
    out = merge_heads(o, B, H)
    assert_close(out, ref, OUT_TOL, "vs Pallas")
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(torch.from_numpy(qkv), H,
                                                    scale)
    assert_close(out, out_p, OUT_TOL, "vs plain")
    assert_close(lse.reshape(B, H, N), lse_p, LSE_TOL, "lse vs plain")


@pytest.mark.parametrize("dh", [32, 64])
def test_online_softmax_matches_window_kernel(dh):
    """N = 256 (a 16 x 16 window, four whole tiles): the grid layout,
    against `window_attention._call_fwd` and the port's plain version."""
    from ssl4gie_tpu.kernels.window_attention import _call_fwd
    H, window = 2, 16
    scale = dh ** -0.5
    grid = bf16_values(np.random.default_rng(20 + dh),
                       (1, 32, 32, 3 * H * dh))
    with pltpu.force_tpu_interpret_mode():
        ref = _call_fwd(jnp.asarray(grid, jnp.bfloat16), H, window, scale)
    ref = np.asarray(ref.astype(jnp.float32))
    x = wa.partition(torch.from_numpy(grid), window)         # (4, 256, 3C)
    o, lse = online_softmax_fwd(*heads(x, H), scale)
    out = wa.merge(merge_heads(o, x.shape[0], H), 1, 32, 32, window)
    # the TPU kernel scales q in bf16 before the product (one rounding more)
    assert_close(out, ref, OUT_TOL, "vs Pallas")
    out_p, lse_p = wa.windowed_attention_fwd_plain(torch.from_numpy(grid), H,
                                                   window, scale)
    assert_close(out, out_p, OUT_TOL, "vs plain")
    assert_close(lse.reshape(lse_p.shape), lse_p, LSE_TOL, "lse vs plain")


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("case", ["full", "n_valid=3", "low_lse"])
def test_online_softmax_matches_flash_kernel(dh, case):
    """The flash layout at N = 256: all keys; n_valid = 3 (three valid keys,
    three whole tiles never visited); and n_valid = 197 with one row whose
    valid logits are all below -100 (lse < -87). Against
    `flash_attention._flash_fwd` (its output and its saved lse) and the
    port's plain version. The Pallas output is taken on bf16 operands, as on
    the model's path; its lse on float32 operands that hold the same bf16
    values, because JAX's CPU dot of bf16 operands does not sum exactly in
    float32 (its lse is 0.09 off float64 at lse = -515, D = 64), while on
    float32 operands it is float32-exact."""
    from ssl4gie_tpu.kernels.flash_attention import _flash_fwd
    rng = np.random.default_rng(30 + dh)
    q, k, v = (bf16_values(rng, (2, 256, dh)) for _ in range(3))
    n_valid = {"full": None, "n_valid=3": 3, "low_lse": 197}[case]
    if case == "low_lse":
        q[0, 0] = 40.0
        k[0] = -np.abs(k[0]) - 1.0
    scale = dh ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, _ = _flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            scale, n_valid)
        _, res = _flash_fwd(*map(jnp.asarray, (q, k, v)), scale, n_valid)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(res[4])[:, 0]                     # (BH, 8, N) -> (BH, N)
    o, lse = online_softmax_fwd(*map(torch.from_numpy, (q, k, v)), scale,
                                n_valid)
    if case == "low_lse":
        assert float(lse[0, 0]) < -87.0
    assert_close(o, ref, OUT_TOL, "vs Pallas")
    assert_close(lse, ref_lse, LSE_TOL, "lse vs Pallas")
    o_p, lse_p = fa.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), scale, n_valid)
    assert_close(o, o_p, OUT_TOL, "vs plain")
    assert_close(lse, lse_p, LSE_TOL, "lse vs plain")
