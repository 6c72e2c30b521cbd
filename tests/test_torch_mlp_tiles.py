"""The work order of the port's fused-MLP kernels
(`ssl4gie_tpu_torch/csrc/gemm_core.cuh:mlp_gemm`, launched by
`csrc/fused_mlp.cu`), emulated in torch on the CPU: the CUDA kernels
themselves run only on the card (the `gpu`-marked tests in
`test_torch_fused_mlp.py` and `chip_smoke.py`).

The emulation walks the tiles as the kernel does. Each launch cuts its
(M, N) output into 128 x BN tiles, BN the widest of 256, 192 and 128 that
divides N (128 in the backward); at most one persistent block per SM (132
on an H100) takes tiles blockIdx, blockIdx + grid, ... with the N tile
fastest. In the forward its two consumer warpgroups own 64 rows of each
tile; in the backward they take its tiles in turn (ping-pong), 128 rows
each. A tile sums its 64-wide k-steps in order, 16 columns a product, in
float32:
- forward (a): h = bf16(x.W1^T + b1);
- forward (b): each 16-wide slice of h (already rounded to bf16) goes
  through the GELU in float32 and is rounded to bf16 as the A operand, then
  y = bf16(gelu(h).W2^T + b2);
- backward: dg = dy.W2 over k-steps of C, then the epilogue reads the tile
  of h once and writes dh = bf16(dg * gelu'(h)) and g = bf16(gelu(h)).
Rows past M are zero-filled on load and dropped on store. The kernel's
tanh form uses the hardware tanh (tanh.approx.f32); the emulation uses
torch's, and the card tests hold the difference.

Held against the JAX package's Pallas kernels (`_mlp_fwd`,
`_mlp_bwd_fused`, interpret mode, bf16) and against the port's plain
versions at the card checks' tolerance, two bf16 ulps (2^-6) of the element
or of the largest element, for both GELU forms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu_torch.kernels import fused_mlp as fm

torch.set_num_threads(1)

BM, BK, KP = 128, 64, 16      # tile rows, k-step, columns of one product
SMS = 132                     # persistent blocks at most (H100 SXM)
TWO_ULPS = 2.0 ** -6
M, C, H = 300, 128, 512       # ragged token count, narrow widths


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def n_tile(n: int, backward: bool = False) -> int:
    """The kernel's N tile: 128 in the backward, else the widest of 256,
    192, 128 that divides n."""
    if backward:
        return 128
    return next(bn for bn in (256, 192, 128) if n % bn == 0)


def schedule(m: int, n: int, bn: int):
    """[(block, m0, n0)] in the order each persistent block walks them."""
    tiles_n = n // bn
    tiles = -(-m // BM) * tiles_n
    grid = min(tiles, SMS)
    return [(b, t // tiles_n * BM, t % tiles_n * bn)
            for b in range(grid) for t in range(b, tiles, grid)]


def gelu(h, approximate):
    return fm._gelu(h, approximate)


def dgelu(h, approximate):
    with torch.enable_grad():
        t = h.detach().requires_grad_(True)
        (d,) = torch.autograd.grad(gelu(t, approximate).sum(), t)
    return d


def gemm_tiles(a, b, n, k_major_b=True, a_op=None):
    """acc (M, n) float32 by the kernel's tile walk: a (M, K), b (n, K)
    (k_major_b) or (K, n); a_op maps each 16-wide A slice (float32 holding
    bf16 values) to its A operand."""
    m, k = a.shape
    bn = n_tile(n, backward=not k_major_b)
    mp = -(-m // BM) * BM
    a = torch.cat([a, torch.zeros((mp - m, k))])     # TMA's zero fill
    acc = torch.zeros((mp, n))
    for _, m0, n0 in schedule(m, n, bn):
        t = torch.zeros((BM, bn))
        for k0 in range(0, k, BK):
            for kk in range(k0, k0 + BK, KP):
                sl = a[m0:m0 + BM, kk:kk + KP]
                if a_op is not None:
                    sl = a_op(sl)
                bt = (b[n0:n0 + bn, kk:kk + KP].T if k_major_b
                      else b[kk:kk + KP, n0:n0 + bn])
                t = t + sl @ bt
        acc[m0:m0 + BM, n0:n0 + bn] = t
    return acc[:m]


def fwd_tiles(x, w1, b1, w2, b2, approximate):
    """(y, h) float32 holding bf16 values; w1 (H, C), w2 (C, H) in
    nn.Linear layout, all float32 holding bf16 values."""
    h = bf16(gemm_tiles(x, w1, w1.shape[0]) + b1)
    y = bf16(gemm_tiles(h, w2, w2.shape[0],
                        a_op=lambda s: bf16(gelu(s, approximate))) + b2)
    return y, h


def bwd_tiles(h, dy, w2, approximate):
    """(dh, g) float32 holding bf16 values; w2 (C, H)."""
    dg = gemm_tiles(dy, w2, w2.shape[1], k_major_b=False)
    return bf16(dg * dgelu(h, approximate)), bf16(gelu(h, approximate))


def assert_close(got, ref, name, tol=TWO_ULPS):
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    err = (got - ref).abs()
    bound = tol * (ref.abs() + ref.abs().max())
    assert bool((err <= bound).all()), (name, err.max().item())


@pytest.mark.parametrize("m,c,hd", [
    (12800, 768, 3072),      # MAE encoder
    (50432, 512, 2048),      # MAE decoder
    (12608, 384, 1536),      # ViT-S, B = 64
    (M, C, H),               # ragged
    (256, 768, 3072),        # fewer tiles than SMs
])
def test_tile_schedule_covers_every_output_once(m, c, hd):
    """Every launch of the forward ((a) N = H over K = C, (b) N = C over
    K = H) and the backward (N = H over K = C): each 64-row slice of each
    output tile is computed by exactly one consumer warpgroup (the forward:
    warpgroup w takes rows 64 w.. of every tile; the backward: the block's
    i-th tile goes whole to warpgroup i % 2), and no block, nor in the
    backward either of its warpgroups, takes more than one tile above any
    other."""
    for n, k, backward in ((hd, c, False), (c, hd, False), (hd, c, True)):
        bn = n_tile(n, backward)
        assert n % bn == 0 and k % (2 * BK) == 0   # whole tiles, even steps
        walk = schedule(m, n, bn)
        tiles = -(-m // BM) * (n // bn)
        grid = min(tiles, SMS)
        seen = np.zeros((-(-m // BM) * 2, n // bn), np.int64)
        per_consumer = np.zeros((grid, 2), np.int64)
        local = np.zeros(grid, np.int64)       # the block's tiles so far
        for b, m0, n0 in walk:
            for half in range(2):
                wg = local[b] % 2 if backward else half
                seen[m0 // 64 + half, n0 // bn] += 1
                per_consumer[b, wg] += 1
            local[b] += 1
        assert len(walk) == tiles
        assert (seen == 1).all()
        assert local.max() - local.min() <= 1
        if backward:   # tiles in turn: one consumer at most one ahead
            assert (per_consumer[:, 0] - per_consumer[:, 1] <= 2).all()
            assert (per_consumer[:, 0] >= per_consumer[:, 1]).all()


@pytest.fixture(scope="module")
def case():
    """bf16-valued float32: x (M, C), w1 (H, C), b1, w2 (C, H), b2, dy."""
    rng = np.random.default_rng(5)
    draw = lambda *s, std=1.0: bf16(torch.from_numpy(
        rng.normal(0, std, s).astype(np.float32)))
    return (draw(M, C), draw(H, C, std=C ** -0.5), draw(H, std=0.02),
            draw(C, H, std=H ** -0.5), draw(C, std=0.02), draw(M, C))


def pallas(case, approximate):
    """The Pallas kernels in interpret mode on bf16 inputs, rows padded to
    a multiple of 128 (rows are independent) and cut back to M."""
    from ssl4gie_tpu.kernels.fused_mlp import _mlp_bwd_fused, _mlp_fwd
    x, w1, b1, w2, b2, dy = case
    mp = -(-M // BM) * BM
    pad = lambda t: np.concatenate([t.numpy(), np.zeros((mp - M, C),
                                                        np.float32)])
    j = lambda t: jnp.asarray(t, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        y, h = _mlp_fwd(j(pad(x)), j(w1.T.numpy()), j(b1.numpy()),
                        j(w2.T.numpy()), j(b2.numpy()),
                        approximate=approximate)
        dh, g = _mlp_bwd_fused(h, j(pad(dy)), j(w2.T.numpy()),
                               approximate=approximate)
    return [np.asarray(t, np.float32)[:M] for t in (y, h, dh, g)]


@pytest.mark.parametrize("approximate", [True, False])
def test_tiles_match_pallas_and_plain(case, approximate):
    x, w1, b1, w2, b2, dy = case
    y, h = fwd_tiles(x, w1, b1, w2, b2, approximate)
    dh, g = bwd_tiles(h, dy, w2, approximate)
    ref = pallas(case, approximate)
    y_p, h_p = fm.mlp_fwd_plain(x, w1.T, b1, w2.T, b2, approximate)
    dh_p, g_p = fm.mlp_bwd_plain(h, dy, w2.T, approximate)
    for got, r, p, name in zip((y, h, dh, g), ref, (y_p, h_p, dh_p, g_p),
                               ("y", "h", "dh", "g")):
        assert bool(torch.isfinite(got).all()), name
        assert_close(got, r, f"{name} vs Pallas")
        assert_close(got, p, f"{name} vs plain")
