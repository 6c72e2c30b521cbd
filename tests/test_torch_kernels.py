"""The port's kernel modules (`ssl4gie_tpu_torch/kernels`) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, on the same
inputs. On CPU tensors the wrappers run their plain PyTorch versions; the
CUDA kernels themselves are checked by the `gpu`-marked tests (skipped
without a card) and by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.data import augment as aug
from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import rotate as rot

torch.set_num_threads(1)

B, H, N, DH = 2, 4, 197, 64          # ViT-B token count, 4 heads
C = H * DH
SCALE = DH ** -0.5


@pytest.fixture()
def qkv_np():
    return np.random.default_rng(1).normal(0, 1, (B, N, 3 * C)).astype(np.float32)


@pytest.fixture()
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the CUDA library."""
    def refuse(*_):
        raise AssertionError("the CPU path must not build the CUDA kernels")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_fused_qkv_attention_matches_pallas(qkv_np):
    """Forward at the JAX test's 2e-4 and the gradient (through
    torch.autograd) at its 2e-3, f32."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention

    def loss(o):
        return jnp.sum(o * jnp.sin(o))

    with pltpu.force_tpu_interpret_mode():
        ref = fused_qkv_attention(jnp.asarray(qkv_np), H, SCALE)
        g_ref = jax.grad(lambda x: loss(fused_qkv_attention(x, H, SCALE)))(
            jnp.asarray(qkv_np))

    x = torch.from_numpy(qkv_np).requires_grad_(True)
    out = da.fused_qkv_attention(x, H, SCALE)
    torch.sum(out * torch.sin(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=2e-3,
                               atol=2e-3)


def test_fused_qkv_attention_dh32_matches_pallas(no_build):
    """Dh = 32 (the MAE decoder's 512 / 16 heads, here 4 heads of 32 at
    N = 197): the wrappers' forward and backward on CPU tensors against the
    Pallas forward and custom VJP, f32, at the JAX test's 2e-4 and 2e-3."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention
    heads, dh = 4, 32
    scale = dh ** -0.5
    rng = np.random.default_rng(5)
    qkv = rng.normal(0, 1, (B, N, 3 * heads * dh)).astype(np.float32)
    dout = rng.normal(0, 1, (B, N, heads * dh)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda x: fused_qkv_attention(x, heads, scale),
                           jnp.asarray(qkv))
        (dref,) = vjp(jnp.asarray(dout))
    out, lse = da.attention_fwd(torch.from_numpy(qkv), heads, scale)
    dqkv = da.attention_bwd(torch.from_numpy(qkv), out, lse,
                            torch.from_numpy(dout), heads, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(dref), rtol=2e-3,
                               atol=2e-3)


def test_attention_wrappers_match_pallas_vjp(qkv_np, no_build):
    """The kernel wrappers on CPU tensors: forward and the explicit backward
    against the Pallas forward and custom VJP; no launch is counted and no
    build is tried."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.dense_attention import fused_qkv_attention

    dout = np.random.default_rng(2).normal(0, 1, (B, N, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda x: fused_qkv_attention(x, H, SCALE),
                           jnp.asarray(qkv_np))
        (dref,) = vjp(jnp.asarray(dout))

    fwd0, bwd0 = da.attention_fwd.launches, da.attention_bwd.launches
    out, lse = da.attention_fwd(torch.from_numpy(qkv_np), H, SCALE)
    dqkv = da.attention_bwd(torch.from_numpy(qkv_np), out, lse,
                            torch.from_numpy(dout), H, SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    # log-sum-exp of each row's scaled scores, in float64
    t = qkv_np.astype(np.float64).reshape(B, N, 3, H, DH).transpose(2, 0, 3, 1, 4)
    s = np.einsum("bhnd,bhmd->bhnm", t[0], t[1]) * SCALE
    smax = s.max(-1)
    np.testing.assert_allclose(
        lse.numpy(), smax + np.log(np.exp(s - smax[..., None]).sum(-1)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(dref), rtol=2e-3,
                               atol=2e-3)
    assert (da.attention_fwd.launches, da.attention_bwd.launches) == (fwd0, bwd0)


def _shear_case(seed, B=3, size=224, Cc=3):
    rng = np.random.default_rng(seed)
    img = rng.random((B, size, size, Cc)).astype(np.float32)
    angle = rng.uniform(-180, 180, B).astype(np.float32)
    return img, angle


def _jax_fold_and_factors(img, angle):
    """The rot90 fold and shear factors exactly as the JAX package's
    `rotate_nearest_shear` computes them."""
    import jax.numpy as jnp
    img = jnp.asarray(img)
    theta = jnp.deg2rad(jnp.asarray(angle))
    q = jnp.round(theta / (0.5 * jnp.pi)).astype(jnp.int32)
    r = theta - q.astype(jnp.float32) * (0.5 * jnp.pi)
    qm = jnp.mod(q, 4)[:, None, None, None]
    xt = jnp.swapaxes(img, 1, 2)
    g = jnp.where(qm == 0, img,
        jnp.where(qm == 1, xt[:, :, ::-1],
        jnp.where(qm == 2, img[:, ::-1, ::-1], xt[:, ::-1, :])))
    P = int(np.ceil(np.tan(np.pi / 8) * (img.shape[1] - 1) / 2.0)) + 1
    return g, np.array(jnp.mod(q, 4)), np.array(jnp.tan(r / 2.0)), \
        np.array(-jnp.sin(r)), P


def test_shear_rotate_matches_pallas_exactly(no_build):
    """Element-exact against `shear_rotate_pallas` (interpret mode) on the
    same canvas and shear factors, and with the rot90 fold done by the
    wrapper from the unfolded image."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.rotate import shear_rotate_pallas

    img, angle = _shear_case(3)
    g, q, alpha, beta, P = _jax_fold_and_factors(img, angle)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(shear_rotate_pallas(g, jnp.asarray(alpha),
                                             jnp.asarray(beta), P, 0.0))
    launches = rot.shear_rotate.launches
    out = rot.shear_rotate(torch.from_numpy(np.array(g)),
                           torch.from_numpy(alpha), torch.from_numpy(beta), 0.0)
    np.testing.assert_array_equal(out.numpy(), ref)
    folded = rot.shear_rotate(torch.from_numpy(img), torch.from_numpy(alpha),
                              torch.from_numpy(beta), 0.0,
                              quarter=torch.from_numpy(q))
    np.testing.assert_array_equal(folded.numpy(), ref)
    assert rot.shear_rotate.launches == launches


@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_shear_rotate_fill_matches_pallas(fill, no_build):
    """A non-square canvas with more channels (as the segmentation affine
    hands the kernel) and a nonzero fill, element-exact."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.rotate import shear_rotate_pallas

    rng = np.random.default_rng(4)
    g = rng.random((2, 48, 64, 5)).astype(np.float32)
    r = rng.uniform(-np.pi / 4, np.pi / 4, 2).astype(np.float32)
    alpha, beta = np.tan(r / 2).astype(np.float32), (-np.sin(r)).astype(np.float32)
    P = int(np.ceil(np.tan(np.pi / 8) * (48 - 1) / 2.0)) + 1
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(shear_rotate_pallas(jnp.asarray(g), jnp.asarray(alpha),
                                             jnp.asarray(beta), P, fill))
    out = rot.shear_rotate(torch.from_numpy(g), torch.from_numpy(alpha),
                           torch.from_numpy(beta), fill)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(4, 197), (3, 160), (2, 512), (1, 1),
                                     (2, 193)])
def test_attention_kernels_match_plain_on_card(cuda, batch, n):
    """bf16 kernels against the plain version on the card, across the routed
    range of N (and N=1; N=193 ends in a 1-key partial tile of the forward):
    two bf16 ulps of the element or of the largest element."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    H12, C12 = 12, 12 * DH
    qkv = torch.randn((batch, n, 3 * C12), generator=gen, device=cuda).bfloat16()
    dout = torch.randn((batch, n, C12), generator=gen, device=cuda).bfloat16()
    n0 = da.attention_fwd.launches
    out, lse = da.attention_fwd(qkv, H12, SCALE)
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, H12, SCALE)
    for got, ref, tol in (
            (out, out_p, 2.0 ** -6), (lse, lse_p, 2.0 ** -16),
            (da.attention_bwd(qkv, out, lse, dout, H12, SCALE),
             da.fused_qkv_attention_bwd_plain(qkv, dout, H12, SCALE),
             2.0 ** -6)):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        bound = tol * (ref.abs() + ref.abs().max())
        assert bool(((got - ref).abs() <= bound).all())
    assert da.attention_fwd.launches == n0 + 1


@pytest.mark.gpu
def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    qkv = torch.zeros((2, N, 3 * C), device=cuda)
    with pytest.raises(TypeError):
        da.attention_fwd(qkv.half(), H, SCALE)           # f16: no instance
    out, lse = da.attention_fwd(qkv, H, SCALE)           # f32 has one
    with pytest.raises(TypeError):                       # dO of another dtype
        da.attention_bwd(qkv, out, lse, out.bfloat16(), H, SCALE)
    with pytest.raises(ValueError):
        da.attention_fwd(qkv.bfloat16(), 16, SCALE)      # Dh = 16
    with pytest.raises(ValueError):
        da.attention_fwd(qkv.bfloat16()[:, :, ::2], 2, SCALE)  # strided


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(4, 197), (3, 160), (2, 512), (2, 50)])
def test_attention_dh32_kernels_match_plain_on_card(cuda, batch, n):
    """The Dh = 32 instantiation (16 heads of 32, the MAE decoder's) against
    the plain version on the card: output and dqkv within two bf16 ulps of
    the element or of the largest element, log-sum-exp within 2^-16."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    heads, dh = 16, 32
    scale = dh ** -0.5
    qkv = torch.randn((batch, n, 3 * heads * dh), generator=gen,
                      device=cuda).bfloat16()
    dout = torch.randn((batch, n, heads * dh), generator=gen,
                       device=cuda).bfloat16()
    n0 = da.attention_bwd.launches
    out, lse = da.attention_fwd(qkv, heads, scale)
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, scale)
    _assert_close_on_card(out, out_p, 2.0 ** -6)
    _assert_close_on_card(lse, lse_p, 2.0 ** -16)
    _assert_close_on_card(
        da.attention_bwd(qkv, out, lse, dout, heads, scale),
        da.fused_qkv_attention_bwd_plain(qkv, dout, heads, scale), 2.0 ** -6)
    assert da.attention_bwd.launches == n0 + 1


def _assert_close_on_card(got, ref, tol):
    """Every element within tol * (|ref| + max|ref|), all finite."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    bound = tol * (ref.abs() + ref.abs().max())
    err = (got - ref).abs()
    assert bool((err <= bound).all()), (err.max().item(), ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("batch,grid,heads,window", [
    (2, (32, 32), 12, 16),      # ViT-Det: 12 heads of 64, 16x16 windows
    (1, (16, 48), 2, 16),       # a non-square grid, one window row
    (2, (16, 16), 4, 8),        # 64-token windows
])
def test_window_attention_kernels_match_plain_on_card(cuda, batch, grid, heads,
                                                      window):
    """bf16 windowed kernels against the plain version (window partition +
    f32 attention) on the card: output and dqkv within two bf16 ulps of the
    element or of the largest element, log-sum-exp within 2^-16."""
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(1)
    C = heads * DH
    qkv = torch.randn((batch, *grid, 3 * C), generator=gen,
                      device=cuda).bfloat16()
    dout = torch.randn((batch, *grid, C), generator=gen, device=cuda).bfloat16()
    n0 = wa.window_attention_fwd.launches
    out, lse = wa.window_attention_fwd(qkv, heads, window, SCALE)
    out_p, lse_p = wa.windowed_attention_fwd_plain(qkv, heads, window, SCALE)
    _assert_close_on_card(out, out_p, 2.0 ** -6)
    _assert_close_on_card(lse, lse_p, 2.0 ** -16)
    _assert_close_on_card(
        wa.window_attention_bwd(qkv, out, lse, dout, heads, window, SCALE),
        wa.windowed_attention_bwd_plain(qkv, dout, heads, window, SCALE),
        2.0 ** -6)
    assert wa.window_attention_fwd.launches == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("bh,n,n_valid", [
    (4, 1024, None), (3, 1024, 1000), (2, 256, 197), (2, 512, 3),
    (2, 4096, None), (1, 4096, 4000), (2, 256, 64), (2, 256, 3),
    (2, 256, 200)])
def test_flash_attention_kernels_match_plain_on_card(cuda, bh, n, n_valid):
    """bf16 flash kernels against the plain version on the card, with and
    without masked keys (n_valid = 64: exactly one valid key tile of the
    forward, the rest never visited; n_valid = 3 and 200 at N = 256: a
    partial last key tile, and dk/dv blocks whose keys are all masked): o,
    dq, dk, dv within two bf16 ulps of the element or of the largest
    element, log-sum-exp within 2^-16."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, dout = (torch.randn((bh, n, DH), generator=gen,
                                 device=cuda).bfloat16() for _ in range(4))
    n0 = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, SCALE, n_valid)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, SCALE, n_valid)
    _assert_close_on_card(o, o_p, 2.0 ** -6)
    _assert_close_on_card(lse, lse_p, 2.0 ** -16)
    grads = fa.flash_bwd(q, k, v, o, lse, dout, SCALE, n_valid)
    for got, ref in zip(grads, fa.flash_attention_bwd_plain(q, k, v, dout,
                                                            SCALE, n_valid)):
        _assert_close_on_card(got, ref, 2.0 ** -6)
    assert fa.flash_fwd.launches == n0 + 1 and fa.flash_bwd.launches >= 1


@pytest.mark.gpu
def test_flash_attention_padded_low_lse_on_card(cuda):
    """The padded-key backward with a row whose valid logits are all below
    -87 (lse about -315) stays finite and agrees with the plain version.
    The row's logits are spread (keys near -1 everywhere) rather than
    dominated by one key: with one-hot probabilities, dS = p (dP - delta)
    cancels and delta's bf16 rounding of O alone exceeds two ulps."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(3)
    q, k, v, dout = (rng.normal(0, 1, (2, 256, DH)).astype(np.float32)
                     for _ in range(4))
    q[0, 0] = 40.0
    k[0] = -1.0 + 0.01 * k[0]
    q, k, v, dout = (torch.from_numpy(a).to(cuda).bfloat16()
                     for a in (q, k, v, dout))
    o, lse = fa.flash_fwd(q, k, v, SCALE, 197)
    assert float(lse[0, 0]) < -87.0
    grads = fa.flash_bwd(q, k, v, o, lse, dout, SCALE, 197)
    for got, ref in zip(grads, fa.flash_attention_bwd_plain(q, k, v, dout,
                                                            SCALE, 197)):
        _assert_close_on_card(got, ref, 2.0 ** -6)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_attention_forwards_repeat_bit_for_bit_on_card(cuda, direction):
    """The forward and backward cores add no atomics and no order that
    changes from run to run, so two runs on the same inputs agree bit for
    bit, in all three layouts (dense at both head widths, windowed, flash
    with masked keys)."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(4)
    rand = lambda *shape: torch.randn(shape, generator=gen,
                                      device=cuda).bfloat16()
    qkv64, qkv32, grid = rand(3, N, 3 * C), rand(2, N, 3 * 16 * 32), \
        rand(1, 32, 32, 3 * C)
    q, k, v = (rand(2, 1024, DH) for _ in range(3))
    fwds = [lambda: da.attention_fwd(qkv64, H, SCALE),
            lambda: da.attention_fwd(qkv32, 16, 32 ** -0.5),
            lambda: wa.window_attention_fwd(grid, H, 16, SCALE),
            lambda: fa.flash_fwd(q, k, v, SCALE, 1000)]
    calls = fwds
    if direction == "backward":
        (o64, l64), (o32, l32), (ow, lw), (of, lf) = (f() for f in fwds)
        d64, d32, dw, df = (rand(*t.shape) for t in (o64, o32, ow, of))
        calls = [lambda: (da.attention_bwd(qkv64, o64, l64, d64, H, SCALE),),
                 lambda: (da.attention_bwd(qkv32, o32, l32, d32, 16,
                                           32 ** -0.5),),
                 lambda: (wa.window_attention_bwd(grid, ow, lw, dw, H, 16,
                                                  SCALE),),
                 lambda: fa.flash_bwd(q, k, v, of, lf, df, SCALE, 1000)]
    for call in calls:
        first, again = call(), call()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_window_and_flash_kernels_reject_what_they_do_not_take(cuda):
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    qkv = torch.zeros((1, 32, 32, 3 * 4 * DH), device=cuda)
    with pytest.raises(TypeError):
        wa.window_attention_fwd(qkv.half(), 4, 16, SCALE)           # f16
    with pytest.raises(ValueError):
        wa.window_attention_fwd(qkv.bfloat16(), 8, 16, SCALE)       # Dh 32
    with pytest.raises(ValueError):
        wa.window_attention_fwd(qkv.bfloat16(), 4, 32, SCALE)       # 1024 tok
    q = torch.zeros((2, 256, DH), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q[:, :200], q[:, :200], q[:, :200], SCALE)     # N % 64
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, SCALE, 0)                             # n_valid


# the float32 instances: outputs within 1e-5 of the largest value,
# gradients within 1e-4, the log-sum-exp within 2^-16 of the element or of
# the largest (3xTF32 products sum in another order than the plain
# version's cuBLAS products, full float32 on both sides)
F32_OUT, F32_GRAD, LSE_TOL = 1e-5, 1e-4, 2.0 ** -16


def _assert_f32_close(got, ref, tol):
    """Every element finite and within tol * max|ref|."""
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = (got - ref.float()).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.fixture()
def full_f32():
    """The plain version's products in full float32, as `build_trainer`
    sets them (`core/config.py:float32_policy`)."""
    from ssl4gie_tpu_torch.core.config import float32_policy
    float32_policy()


@pytest.mark.gpu
@pytest.mark.parametrize("dh,heads", [(64, 12), (32, 16), (80, 16)])
@pytest.mark.parametrize("batch,n", [(3, 197), (2, 160), (2, 512)])
def test_attention_f32_kernels_match_plain_on_card(cuda, full_f32, dh, heads,
                                                   batch, n):
    """The float32 packed-QKV instance at each head width (ViT-B, the MAE
    decoder, ViT-H) against the plain version on the card; only the f32
    counters move."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    scale = dh ** -0.5
    qkv = torch.randn((batch, n, 3 * heads * dh), generator=gen, device=cuda)
    dout = torch.randn((batch, n, heads * dh), generator=gen, device=cuda)
    n0 = (da.attention_fwd.launches, da.attention_bwd.launches,
          da.attention_fwd.launches_f32, da.attention_bwd.launches_f32)
    out, lse = da.attention_fwd(qkv, heads, scale)
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, scale)
    _assert_f32_close(out, out_p, F32_OUT)
    _assert_close_on_card(lse, lse_p, LSE_TOL)
    _assert_f32_close(da.attention_bwd(qkv, out, lse, dout, heads, scale),
                      da.fused_qkv_attention_bwd_plain(qkv, dout, heads,
                                                       scale), F32_GRAD)
    assert (da.attention_fwd.launches, da.attention_bwd.launches,
            da.attention_fwd.launches_f32,
            da.attention_bwd.launches_f32) == (n0[0], n0[1], n0[2] + 1,
                                               n0[3] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(3, 197), (2, 160), (2, 512), (1, 180)])
def test_attention_dh80_kernels_match_plain_on_card(cuda, batch, n):
    """The bf16 instance at Dh = 80 (16 heads, the MAE ViT-H's; its tiles
    split into a 128-byte and a 32-byte swizzled part) against the plain
    version: two bf16 ulps, log-sum-exp within 2^-16."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    heads, dh = 16, 80
    scale = dh ** -0.5
    qkv = torch.randn((batch, n, 3 * heads * dh), generator=gen,
                      device=cuda).bfloat16()
    dout = torch.randn((batch, n, heads * dh), generator=gen,
                       device=cuda).bfloat16()
    n0 = (da.attention_fwd.launches, da.attention_fwd.launches_f32)
    out, lse = da.attention_fwd(qkv, heads, scale)
    out_p, lse_p = da.fused_qkv_attention_fwd_plain(qkv, heads, scale)
    _assert_close_on_card(out, out_p, 2.0 ** -6)
    _assert_close_on_card(lse, lse_p, LSE_TOL)
    _assert_close_on_card(
        da.attention_bwd(qkv, out, lse, dout, heads, scale),
        da.fused_qkv_attention_bwd_plain(qkv, dout, heads, scale), 2.0 ** -6)
    assert (da.attention_fwd.launches,
            da.attention_fwd.launches_f32) == (n0[0] + 1, n0[1])


@pytest.mark.gpu
@pytest.mark.parametrize("batch,grid,heads,window", [
    (2, (32, 32), 12, 16), (1, (16, 48), 2, 16), (2, (16, 16), 4, 8)])
def test_window_attention_f32_kernels_match_plain_on_card(
        cuda, full_f32, batch, grid, heads, window):
    """The float32 windowed instance against the plain version."""
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(8)
    C = heads * DH
    qkv = torch.randn((batch, *grid, 3 * C), generator=gen, device=cuda)
    dout = torch.randn((batch, *grid, C), generator=gen, device=cuda)
    n0 = (wa.window_attention_fwd.launches,
          wa.window_attention_fwd.launches_f32)
    out, lse = wa.window_attention_fwd(qkv, heads, window, SCALE)
    out_p, lse_p = wa.windowed_attention_fwd_plain(qkv, heads, window, SCALE)
    _assert_f32_close(out, out_p, F32_OUT)
    _assert_close_on_card(lse, lse_p, LSE_TOL)
    _assert_f32_close(
        wa.window_attention_bwd(qkv, out, lse, dout, heads, window, SCALE),
        wa.windowed_attention_bwd_plain(qkv, dout, heads, window, SCALE),
        F32_GRAD)
    assert (wa.window_attention_fwd.launches,
            wa.window_attention_fwd.launches_f32) == (n0[0], n0[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,n,n_valid", [
    (4, 1024, None), (3, 1024, 1000), (2, 512, 3), (2, 256, 197),
    (2, 256, 64), (1, 4096, 4000)])
def test_flash_attention_f32_kernels_match_plain_on_card(cuda, full_f32, bh,
                                                         n, n_valid):
    """The float32 flash instance against the plain version, with and
    without masked keys (a partial last key tile; one valid tile; dk/dv
    blocks whose keys are all masked)."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, dout = (torch.randn((bh, n, DH), generator=gen, device=cuda)
                     for _ in range(4))
    n0 = (fa.flash_fwd.launches, fa.flash_fwd.launches_f32)
    o, lse = fa.flash_fwd(q, k, v, SCALE, n_valid)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, SCALE, n_valid)
    _assert_f32_close(o, o_p, F32_OUT)
    _assert_close_on_card(lse, lse_p, LSE_TOL)
    grads = fa.flash_bwd(q, k, v, o, lse, dout, SCALE, n_valid)
    for got, ref in zip(grads, fa.flash_attention_bwd_plain(q, k, v, dout,
                                                            SCALE, n_valid)):
        _assert_f32_close(got, ref, F32_GRAD)
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_f32) == (n0[0],
                                                                  n0[1] + 1)


@pytest.mark.gpu
def test_attention_f32_and_dh80_repeat_bit_for_bit_on_card(cuda):
    """The float32 instances (dense at the three head widths, windowed,
    flash with masked keys) and the Dh-80 bf16 instance add no atomics:
    two runs of each forward and backward agree bit for bit."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(10)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=cuda)
    q, k, v = (rand(2, 1024, DH) for _ in range(3))
    grid = rand(1, 32, 32, 3 * C)
    dense = [(rand(2, N, 3 * h * dh), h, dh ** -0.5)
             for h, dh in ((12, 64), (16, 32), (16, 80))]
    dense.append((dense[-1][0].bfloat16(), 16, 80 ** -0.5))
    fwds = [(lambda x=x, h=h, s=s: da.attention_fwd(x, h, s),
             lambda x, o, l, d, h=h, s=s: (da.attention_bwd(x, o, l, d, h,
                                                           s),))
            for x, h, s in dense]
    fwds.append((lambda: wa.window_attention_fwd(grid, H, 16, SCALE),
                 lambda x, o, l, d: (wa.window_attention_bwd(
                     x, o, l, d, H, 16, SCALE),)))
    fwds.append((lambda: fa.flash_fwd(q, k, v, SCALE, 1000),
                 lambda x, o, l, d: fa.flash_bwd(q, k, v, o, l, d, SCALE,
                                                 1000)))
    inputs = [x for x, _, _ in dense] + [grid, q]
    for (fwd, bwd), x in zip(fwds, inputs):
        (o, lse), (o2, lse2) = fwd(), fwd()
        d = torch.randn_like(o.float()).to(o.dtype)
        first, again = bwd(x, o, lse, d), bwd(x, o, lse, d)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense_dh64", "dense_dh32", "dense_dh80",
                                  "window", "flash", "flash_1000"])
def test_f32_forward_repeats_bit_for_bit_on_card(cuda, case):
    """The 3xTF32 forward (no atomics; each tile's P.V added by an FMA in
    a fixed order) called twice on the same inputs gives bitwise-equal
    output and lse, at the paths' shapes: the dense layout at (64, 197) 12
    x 64, (256, 197) 16 x 32 and (64, 180) 16 x 80, the detection grid (4,
    64, 64) in 16 x 16 windows, the flash layout at (48, 4096, 64) with
    all and with 1000 valid keys."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(12)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=cuda)
    dense = {"dense_dh64": (64, 197, 12, 64), "dense_dh32": (256, 197, 16, 32),
             "dense_dh80": (64, 180, 16, 80)}
    if case in dense:
        b, n, heads, dh = dense[case]
        qkv = rand(b, n, 3 * heads * dh)
        fwd = lambda: da.attention_fwd(qkv, heads, dh ** -0.5)
    elif case == "window":
        qkv = rand(4, 64, 64, 3 * C)
        fwd = lambda: wa.window_attention_fwd(qkv, H, 16, SCALE)
    else:
        n_valid = 1000 if case == "flash_1000" else None
        q, k, v = (rand(48, 4096, DH) for _ in range(3))
        fwd = lambda: fa.flash_fwd(q, k, v, SCALE, n_valid)
    (o, lse), (o2, lse2) = fwd(), fwd()
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flash_1000", "flash_3", "window"])
def test_f32_backward_repeats_bit_for_bit_on_card(cuda, case):
    """The 3xTF32 backward (two kernels, no atomics) called twice on the
    same inputs gives bitwise-equal dq, dk and dv: at the flash path's
    (48, 4096, 64) with 1000 and 3 valid keys, and on the detection grid
    (4, 64, 64) in 16 x 16 windows."""
    from ssl4gie_tpu_torch.kernels import flash_attention as fa
    from ssl4gie_tpu_torch.kernels import window_attention as wa
    gen = torch.Generator(device=cuda).manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=cuda)
    if case == "window":
        qkv, dout = rand(4, 64, 64, 3 * C), rand(4, 64, 64, C)
        o, lse = wa.window_attention_fwd(qkv, H, 16, SCALE)
        bwd = lambda: wa.window_attention_bwd(qkv, o, lse, dout, H, 16,
                                              SCALE).split(C, -1)
    else:
        n_valid = int(case.split("_")[1])
        q, k, v, dout = (rand(48, 4096, DH) for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, SCALE, n_valid)
        bwd = lambda: fa.flash_bwd(q, k, v, o, lse, dout, SCALE, n_valid)
    first, again = bwd(), bwd()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


@pytest.mark.gpu
def test_shear_rotate_kernel_matches_plain_on_card(cuda):
    img, angle = _shear_case(5, B=4)
    from ssl4gie_tpu_torch.data.augment import rotation_factors
    img = torch.from_numpy(img).to(cuda).bfloat16()
    q, alpha, beta = rotation_factors(torch.from_numpy(angle).to(cuda))
    got = rot.shear_rotate(img, alpha, beta, 0.0, quarter=q)
    torch.cuda.synchronize()
    assert torch.equal(got, rot.shear_rotate_plain(img, alpha, beta, 0.0,
                                                   quarter=q))


BOUNDARY_ANGLES = (0.0, 90.0, 180.0, -90.0, 45.0, -45.0, 135.0, -135.0)


@pytest.mark.parametrize("size", [224, 352])
def test_rotation_source_box_fits_the_staged_box(size):
    """The kernel stages each 32 x 32 output tile's source box in shared
    memory sized for csrc/rotate.cu's kBoxPix pixels a side. Over the
    boundary angles and 60 random ones, every tile's box (in the folded
    canvas: the fold only permutes axes) is at most 46 x 46 pixels."""
    import re
    from pathlib import Path
    src = Path(rot.__file__).resolve().parent.parent / "csrc" / "rotate.cu"
    box_pix = int(re.search(r"kBoxPix = (\d+)", src.read_text())[1])
    angle = torch.cat([torch.tensor(BOUNDARY_ANGLES),
                       torch.rand(60, generator=torch.Generator()
                                  .manual_seed(0)) * 360 - 180])
    _, alpha, beta = aug.rotation_factors(angle)
    n, t = angle.shape[0], size // 32
    c = (size - 1) / 2.0
    y = torch.arange(size).reshape(1, size, 1)
    x = torch.arange(size).reshape(1, 1, size)
    a, be = alpha.reshape(n, 1, 1), beta.reshape(n, 1, 1)
    u = x + rot._shift(a, y, c)
    y2 = y + rot._shift(be, u, c)
    x2 = u + rot._shift(a, y2, c)
    valid = (y2 >= 0) & (y2 < size) & (x2 >= 0) & (x2 < size)
    worst = 0
    for v in (y2, x2):
        tiles = v.reshape(n, t, 32, t, 32).transpose(2, 3)
        ok = valid.reshape(n, t, 32, t, 32).transpose(2, 3)
        big = torch.iinfo(torch.int64).max
        hi = torch.where(ok, tiles, -big).amax(dim=(3, 4))
        lo = torch.where(ok, tiles, big).amin(dim=(3, 4))
        worst = max(worst, int((hi - lo + 1)[ok.any(dim=(3, 4))].max()))
    assert worst == 46 and worst <= box_pix


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 224, 224, 3), (48, 352, 352, 5),
                                   (48, 224, 224, 3)])
@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_rotate_kernel_matches_plain_on_card(cuda, shape, fill):
    """The path shapes (the ViT classification batch, the seg canvas, the
    RN50 classification batch), random and boundary angles, element for
    element."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    angle = torch.rand((shape[0],), generator=gen, device=cuda) * 360 - 180
    angle[:len(BOUNDARY_ANGLES)] = torch.tensor(BOUNDARY_ANGLES, device=cuda)
    q, alpha, beta = aug.rotation_factors(angle)
    got = rot.shear_rotate(g, alpha, beta, fill, quarter=q)
    torch.cuda.synchronize()
    assert torch.equal(got, rot.shear_rotate_plain(g, alpha, beta, fill,
                                                   quarter=q))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 100, 100, 1), (2, 70, 90, 3),
                                   (2, 40, 40, 9)])
def test_rotate_kernel_odd_shapes_on_card(cuda, shape):
    """Rows that are not a multiple of 16 bytes, partial tiles, non-square
    canvases without the fold, and a channel count with no instantiation of
    its own; shear factors past 45 degrees (a box larger than the staged
    one) read pixel by pixel."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    Bn = shape[0]
    alpha = torch.rand((Bn,), generator=gen, device=cuda) * 3 - 1.5
    beta = torch.rand((Bn,), generator=gen, device=cuda) * 3 - 1.5
    got = rot.shear_rotate(g, alpha, beta, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, rot.shear_rotate_plain(g, alpha, beta, 0.5))


@pytest.mark.gpu
def test_seg_affine_on_card_goes_through_the_kernel(cuda, monkeypatch):
    """The seg augmentation's affine in bf16 on the card launches the
    kernel once, and gives what the same algorithm gives on the card with
    the rotation's plain version in its place: element for element."""
    gen = torch.Generator().manual_seed(2)
    img = torch.randn((4, 224, 224, 3), generator=gen).bfloat16().to(cuda)
    mask = (torch.rand((4, 224, 224, 1), generator=gen) > 0.5).float().to(cuda)
    p = aug.sample_affine_params(4, 224, gen)
    n = rot.shear_rotate.launches
    gi, gm = aug.apply_affine(img, mask, p)
    assert rot.shear_rotate.launches == n + 1
    monkeypatch.setattr(aug, "shear_rotate", rot.shear_rotate_plain)
    ri, rm = aug.apply_affine(img, mask, p)
    assert torch.equal(gi, ri) and torch.equal(gm, rm)
