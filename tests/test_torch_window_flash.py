"""The port's windowed- and flash-attention modules
(`ssl4gie_tpu_torch/kernels/window_attention.py`, `flash_attention.py`)
against the JAX package's Pallas kernels in interpret mode on the CPU, on the
same inputs, in float32. On CPU tensors the wrappers run their plain PyTorch
versions, never the CUDA kernels (those are checked by the `gpu`-marked
tests in `test_torch_kernels.py` and by `chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import window_attention as wa

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 2e-4, 3e-3     # as tests/test_window_attention.py


@pytest.fixture()
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the CUDA library."""
    def refuse(*_):
        raise AssertionError("the CPU path must not build the CUDA kernels")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("shape,heads,window", [
    ((2, 16, 16, 3 * 128), 4, 8),       # tests/test_window_attention.py
    ((1, 32, 32, 3 * 128), 2, 16),      # Dh = 64, ViTDet's 16x16 windows
])
def test_windowed_attention_matches_pallas(shape, heads, window, no_build):
    """Forward 2e-4 and the gradient of sum(sin(o)) 3e-3, through the port's
    autograd and through its explicit backward; no launch is counted."""
    from ssl4gie_tpu.kernels.window_attention import windowed_flash_attention
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    scale = (shape[-1] // 3 // heads) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda q: windowed_flash_attention(
            q, heads, window, scale), jnp.asarray(x))
        (g_ref,) = vjp(jnp.cos(ref))

    n0 = (wa.window_attention_fwd.launches, wa.window_attention_bwd.launches)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = wa.windowed_flash_attention(xt, heads, window, scale)
    torch.sum(torch.sin(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref),
                               rtol=GRAD_TOL, atol=GRAD_TOL)

    o, lse = wa.window_attention_fwd(torch.from_numpy(x), heads, window, scale)
    assert tuple(lse.shape) == (shape[0] * (shape[1] // window) *
                                (shape[2] // window), heads, window * window)
    g = wa.window_attention_bwd(torch.from_numpy(x), o, lse,
                                torch.cos(o), heads, window, scale)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    assert (wa.window_attention_fwd.launches,
            wa.window_attention_bwd.launches) == n0


def _flash_case(seed, BH, N, D=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (BH, N, D)).astype(np.float32) for _ in range(3)]


def test_flash_attention_matches_pallas(no_build):
    """(2, 512, 64) as tests/test_flash_attention.py: the forward 2e-4 and
    the gradients of sum(o * cos(o)) 3e-3; the wrappers' log-sum-exp against
    float64."""
    from ssl4gie_tpu.kernels import flash_attention as jfa
    q, k, v = _flash_case(0, 2, 512)
    scale = 64 ** -0.5

    def loss_j(q, k, v):
        o = jfa.flash_attention(q, k, v, scale)
        return jnp.sum(o * jnp.cos(o)), o

    with pltpu.force_tpu_interpret_mode():
        (_, ref), grads = jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, scale)
    torch.sum(out * torch.cos(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for t, g, name in zip(ts, grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)

    n0 = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    _, lse = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), scale)
    s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k) * scale
    smax = s.max(-1)
    np.testing.assert_allclose(
        lse.numpy(), smax + np.log(np.exp(s - smax[..., None]).sum(-1)),
        rtol=1e-5, atol=1e-5)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == n0


@pytest.mark.parametrize("d", [64, 40])
def test_flash_padded_gradients_low_lse(d, no_build):
    """tests/test_flash_attention.py:65 through `flash_attention_heads`: 197
    tokens padded to 256 and masked through n_valid, one row with all its
    valid logits below -100 (lse < -87); grads finite and within 3e-3 of the
    interpret-mode Pallas kernel. D = 40 goes through `_pad_d`."""
    from ssl4gie_tpu.kernels import flash_attention as jfa
    BH, N = 2, 197
    q, k, v = _flash_case(3, BH, N, d)
    q[0, 0] = 40.0
    k[0] = -np.abs(k[0]) - 1.0
    scale = d ** -0.5

    def loss_j(q, k, v):
        o = jfa.flash_attention_heads(q[:, None], k[:, None], v[:, None],
                                      scale)[:, 0]
        return jnp.sum(o * jnp.cos(o))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss_j, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention_heads(*(t[:, None] for t in ts), scale)[:, 0]
    torch.sum(o * torch.cos(o)).backward()
    for t, g, name in zip(ts, grads, "qkv"):
        assert bool(torch.isfinite(t.grad).all()), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_flash_masked_keys_get_zero_gradient(no_build):
    """Keys >= n_valid take no part: the output equals attention over the
    valid keys alone, and their dk, dv are exactly zero."""
    q, k, v = _flash_case(4, 2, 256)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, 0.125, n_valid=100)
    out.sum().backward()
    s = torch.from_numpy(q) @ torch.from_numpy(k[:, :100]).transpose(1, 2)
    ref = torch.softmax(s * 0.125, -1) @ torch.from_numpy(v[:, :100])
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not ts[1].grad[:, 100:].any() and not ts[2].grad[:, 100:].any()
    with pytest.raises(ValueError):
        fa.flash_attention(*ts[:3], 0.125, n_valid=0)
    with pytest.raises(ValueError):
        fa.flash_attention(ts[0][:, :200], ts[1][:, :200], ts[2][:, :200],
                           0.125)


def test_attention_routes_copy_the_jax_ranges(monkeypatch):
    """`Attention` sends a windowed block to the window kernel, a global
    sequence of >= 1024 tokens (a multiple of 256) to the flash kernel,
    160..512 tokens to the packed-QKV kernel and the rest to plain
    attention; on CPU tensors each kernel route runs its plain version."""
    from ssl4gie_tpu_torch.models import layers
    calls = []
    for name in ("windowed_flash_attention", "flash_attention_heads",
                 "fused_qkv_attention", "plain_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    dim, heads = 128, 2
    cases = [(16, (32, 32), "windowed_flash_attention"),
             (None, (32, 32), "flash_attention_heads"),
             (None, (16, 16), "fused_qkv_attention"),
             (None, (8, 8), "plain_attention"),
             (None, (36, 36), "plain_attention")]     # 1296 % 256 != 0
    for window, (gh, gw), route in cases:
        attn = layers.Attention(dim, heads, window).eval()
        calls.clear()
        with torch.no_grad():
            out = attn(torch.randn(1, gh * gw, dim), (gh, gw))
        assert out.shape == (1, gh * gw, dim)
        assert calls[0] == route, (window, gh, calls)
