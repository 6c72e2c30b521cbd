"""The bf16 LayerNorm (`kernels/layer_norm.py`, `csrc/layer_norm.cu`) and its
route in `models/layers.py:layer_norm`.

CPU: the route keeps today's formula bitwise on CPU tensors and launches
nothing; the plain forward and backward that the kernels are held to agree
with autograd of that formula and, in bf16, with flax's
`nn.LayerNorm(epsilon=1e-6, dtype=bfloat16)` over float32 scale and bias
(JAX is imported in a module-scoped fixture, so the file imports no JAX).

Card (marked `gpu`: skipped without a card; on the GPU machine run with
`--noconftest`): the kernels against the plain version at the port's
widths, bitwise reruns, a constant row, the inputs they refuse, and the
launches of a MAE ViT-B step in bf16 and in float32.
"""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import layer_norm as lnk
from ssl4gie_tpu_torch.models import layers

torch.set_num_threads(1)

EPS = 1e-6
# (M, C): the MAE encoder's and decoder's rows, the pooled fc_norm, odd
# rows, ViT-S, ViT-L, ViT-H, the ViTDet FPN and a narrow test width
CARD_SHAPES = [(12800, 768), (50432, 512), (64, 768), (7, 384), (1000, 1024),
               (333, 1280), (4096, 256), (100, 64)]


def _inputs(m: int, c: int, device, seed: int = 0):
    """x bf16 rows off zero mean (as a residual stream is), dy bf16, and
    float32 scale and bias near their init."""
    g = np.random.default_rng(seed)
    x = g.normal(0.3, 1.5, (m, c)) + g.normal(0, 2, (m, 1))
    dy = g.normal(0, 1, (m, c))
    w = 1 + 0.1 * g.normal(0, 1, c)
    b = 0.1 * g.normal(0, 1, c)

    def t(a, dt):
        return torch.tensor(a, dtype=torch.float32).to(dt).to(device)
    return (t(x, torch.bfloat16), t(dy, torch.bfloat16), t(w, torch.float32),
            t(b, torch.float32))


def _todays(x, w, b, dy):
    """Today's formula (the route before the kernel) and its gradients by
    autograd: (y, dx, dgamma, dbeta)."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    y = F.layer_norm(x.to(torch.float32), (x.shape[-1],), w, b,
                     EPS).to(x.dtype)
    y.backward(dy)
    return y.detach(), x.grad, w.grad, b.grad


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |t| (8 significant bits)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _within_ulp(name, got, ref, terms: torch.Tensor) -> None:
    """Each element within one bf16 ulp of the reference, plus 2^-20 of
    the largest term the row's float32 arithmetic added (where the result
    cancels, two float32 orders differ by that much before rounding)."""
    err = (got.float() - ref.float()).abs()
    tol = _bf16_ulp(ref) + 2.0 ** -20 * terms.float().abs().amax(
        dim=-1, keepdim=True)
    assert bool(torch.isfinite(got.float()).all()), name
    assert bool((err <= tol).all()), (
        f"{name}: max|err| {err.max().item():.4g}, worst over tolerance "
        f"{(err / tol).max().item():.3g}")


@pytest.fixture()
def no_build(monkeypatch):
    def refuse(*_):
        raise AssertionError("the CPU path must not build the CUDA kernels")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return lnk.layer_norm_fwd.launches, lnk.layer_norm_bwd.launches


def _by_width():
    return (collections.Counter(lnk.layer_norm_fwd.by_width),
            collections.Counter(lnk.layer_norm_bwd.by_width))


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_on_cpu_is_todays_formula(dtype, no_build):
    """`layers.layer_norm` on CPU tensors: output and gradients bitwise
    today's `F.layer_norm(x.to(float32), ...).to(dtype)`; no launch."""
    x, dy, w, b = _inputs(6, 96, "cpu")
    x, dy = x.to(dtype), dy.to(dtype)
    ln = torch.nn.LayerNorm(96, eps=EPS)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    before = _counts()
    xg = x.clone().requires_grad_(True)
    y = layers.layer_norm(xg, ln, dtype)
    y.backward(dy)
    ref = _todays(x, w, b, dy)
    assert y.dtype == dtype
    for got, want in zip((y, xg.grad, ln.weight.grad, ln.bias.grad), ref):
        assert torch.equal(got, want)
    assert _counts() == before


def test_plain_pair_matches_autograd_of_todays_formula():
    """The kernels' plain forward and backward (`layer_norm_fwd_plain`,
    `layer_norm_bwd_plain`) against autograd of today's formula on bf16
    rows: y bitwise; dx within one bf16 ulp; dgamma, dbeta within 1e-6 of
    each tensor's largest (float32 sums in another order)."""
    x, dy, w, b = _inputs(40, 256, "cpu", seed=3)
    y, stats = lnk.layer_norm_fwd_plain(x, w, b, EPS)
    dx, dw, db = lnk.layer_norm_bwd_plain(dy, x, stats, w)
    y_ref, dx_ref, dw_ref, db_ref = _todays(x, w, b, dy)
    assert torch.equal(y, y_ref)
    _within_ulp("dx", dx, dx_ref, dy.float() * w * stats[1, :, None])
    for name, got, want in (("dgamma", dw, dw_ref), ("dbeta", db, db_ref)):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max(), name


@pytest.fixture(scope="module")
def flax_ln():
    """flax's bf16 LayerNorm over float32 scale and bias on one (64, 768)
    input: the inputs, its output and its VJP, as numpy."""
    import jax
    import jax.numpy as jnp
    import flax.linen as nn

    x, dy, w, b = _inputs(64, 768, "cpu", seed=5)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    dyj = jnp.asarray(dy.float().numpy()).astype(jnp.bfloat16)
    params = {"params": {"scale": jnp.asarray(w.numpy()),
                         "bias": jnp.asarray(b.numpy())}}
    mod = nn.LayerNorm(epsilon=EPS, dtype=jnp.bfloat16)
    y, vjp = jax.vjp(lambda p, v: mod.apply(p, v), params, xj)
    dp, dxj = vjp(dyj)
    f = np.float32
    return {"x": x, "dy": dy, "w": w, "b": b,
            "y": np.asarray(y.astype(f)), "dx": np.asarray(dxj.astype(f)),
            "dw": np.asarray(dp["params"]["scale"]),
            "db": np.asarray(dp["params"]["bias"]),
            "dtypes": (y.dtype, dxj.dtype, dp["params"]["scale"].dtype)}


def test_plain_bf16_layer_norm_matches_flax(flax_ln):
    """The port's bf16 LayerNorm against flax's (the reference's rounding
    points: statistics, scale and bias in float32, y and dx rounded to bf16
    once): the route's plain version by autograd, and the kernels' plain
    pair. y within one bf16 ulp (flax takes the variance as E[x^2] -
    E[x]^2, torch in another float32 order). flax's VJP rounds the
    cotangents of x's two uses (x - mean, and the statistics) to bf16 apart
    and adds them in bf16 (the jaxpr of its VJP on the CPU), where the port
    rounds dx once: dx within one bf16 ulp of the element plus one of each
    path's term. dgamma and dbeta, float32 in both, within 1e-5 of each
    tensor's largest."""
    r = flax_ln
    assert [str(d) for d in r["dtypes"]] == ["bfloat16", "bfloat16",
                                            "float32"]
    x, dy, w, b = r["x"], r["dy"], r["w"], r["b"]
    y, dx, dw, db = _todays(x, w, b, dy)
    y2, stats = lnk.layer_norm_fwd_plain(x, w, b, EPS)
    dx2, dw2, db2 = lnk.layer_norm_bwd_plain(dy, x, stats, w)
    mean, rstd = stats
    ref = {k: torch.tensor(r[k]) for k in ("y", "dx", "dw", "db")}
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    g = dy.float() * w
    direct = g * rstd[:, None]
    stats = rstd[:, None] * (g.mean(-1, keepdim=True)
                             + xhat * (g * xhat).mean(-1, keepdim=True))
    paths = _bf16_ulp(direct) + _bf16_ulp(stats)
    for tag, yy, dd, gw, gb in (("route", y, dx, dw, db),
                                ("plain pair", y2, dx2, dw2, db2)):
        _within_ulp(f"{tag} y", yy, ref["y"], xhat * w + b)
        err = (dd.float() - ref["dx"]).abs()
        assert bool((err <= _bf16_ulp(ref["dx"]) + paths).all()), tag
        for name, got, want in (("dgamma", gw, ref["dw"]),
                                ("dbeta", gb, ref["db"])):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (
                tag, name)


@pytest.mark.parametrize("case", ["float32", "width12", "width2056",
                                  "bias_bf16"])
def test_checks_refuse_what_the_kernel_does_not_take(case):
    """The wrapper's checks (device-independent) raise on a float32 x, a
    width that is not a multiple of 8 or is above 2,048, and bf16 bias."""
    c = {"width12": 12, "width2056": 2056}.get(case, 64)
    x, _, w, b = _inputs(4, c, "cpu")
    if case == "float32":
        x = x.float()
    if case == "bias_bf16":
        b = b.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        lnk._check(x, ("weight", w, torch.float32, (c,)),
                   ("bias", b, torch.float32, (c,)))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 768)])
def test_checks_take_sound_rows(shape):
    """The same checks pass bf16 rows (..., C) with float32 scale and bias
    and give the kernels' (M, C)."""
    c = shape[-1]
    x, _, w, b = _inputs(int(np.prod(shape[:-1])), c, "cpu")
    x = x.reshape(shape)
    got = lnk._check(x, ("weight", w, torch.float32, (c,)),
                     ("bias", b, torch.float32, (c,)))
    assert got == (int(np.prod(shape[:-1])), c)


def test_backward_grid_covers_the_rows(monkeypatch):
    """The backward's blocks: one per 8 rows (4 above 1,024 columns), at
    most two an SM (132 SMs here)."""
    monkeypatch.setattr(lnk, "_sms", lambda device: 132)
    assert lnk._parts(50432, 512, None) == 264
    assert lnk._parts(64, 768, None) == 8
    assert lnk._parts(7, 1280, None) == 2
    assert lnk._parts(1, 64, None) == 1


# ----------------------------------------------------------------- card

@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernels_match_plain_on_card(cuda, shape):
    """Forward: y within one bf16 ulp, mean within 1e-6 of the row's
    largest |x|, rstd within 1e-6 of itself. Backward (against autograd of
    today's formula on the card): dx within one bf16 ulp, dgamma and dbeta
    within 1e-5 of each tensor's largest."""
    m, c = shape
    x, dy, w, b = _inputs(m, c, cuda, seed=m + c)
    y, stats = lnk.layer_norm_fwd(x, w, b, EPS)
    dx, dw, db = lnk.layer_norm_bwd(dy, x, stats, w)
    torch.cuda.synchronize()
    mean, rstd = stats
    y_p, (mean_p, rstd_p) = lnk.layer_norm_fwd_plain(x, w, b, EPS)
    xhat = (x.float() - mean_p[:, None]) * rstd_p[:, None]
    _within_ulp("y", y, y_p, xhat * w + b)
    row_max = x.float().abs().amax(-1)
    assert bool(((mean - mean_p).abs() <= 1e-6 * row_max).all())
    assert bool(((rstd - rstd_p).abs() <= 1e-6 * rstd_p).all())
    _, dx_r, dw_r, db_r = _todays(x, w, b, dy)
    _within_ulp("dx", dx, dx_r, dy.float() * w * rstd_p[:, None])
    for name, got, want in (("dgamma", dw, dw_r), ("dbeta", db, db_r)):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (name, err)


@pytest.mark.gpu
def test_kernels_rerun_bitwise(cuda):
    """Two runs at the decoder's shape: every output bitwise equal (no
    atomics; the partial sums have a fixed order)."""
    x, dy, w, b = _inputs(50432, 512, cuda, seed=1)
    outs = []
    for _ in range(2):
        y, stats = lnk.layer_norm_fwd(x, w, b, EPS)
        outs.append((y, stats, *lnk.layer_norm_bwd(dy, x, stats, w)))
    torch.cuda.synchronize()
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_constant_row_stays_finite(cuda):
    """A row of one value: var 0, rstd = 1 / sqrt(eps), y = beta, dx
    finite."""
    x, dy, w, b = _inputs(16, 768, cuda)
    x[3] = 2.5
    y, stats = lnk.layer_norm_fwd(x, w, b, EPS)
    dx, dw, db = lnk.layer_norm_bwd(dy, x, stats, w)
    torch.cuda.synchronize()
    mean = stats[0]
    for t in (y, stats, dx, dw, db):
        assert bool(torch.isfinite(t.float()).all())
    assert mean[3].item() == 2.5
    assert torch.equal(y[3], b.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float32", "width12", "width2056",
                                  "noncontiguous"])
def test_kernels_refuse_on_card(cuda, case):
    """Each raises rather than falls back: a float32 x, a width not a
    multiple of 8, a width above 2,048, a non-contiguous x."""
    c = {"width12": 12, "width2056": 2056}.get(case, 64)
    x, _, w, b = _inputs(8, c, cuda)
    if case == "float32":
        x = x.float()
    if case == "noncontiguous":
        x = x.t()       # (64, 8), a view
    with pytest.raises((TypeError, ValueError)):
        lnk.layer_norm(x, w, b, EPS)


def _mae_step(dtype, device):
    from ssl4gie_tpu_torch.ssl.mae import MAE
    model = MAE(dtype=dtype, device=device,
                generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(1)
    imgs = torch.randn((4, 224, 224, 3), generator=g, device=device)
    noise = model.draw_noise(4, g)
    before, widths = _counts(), _by_width()
    loss, _, _ = model(imgs, noise)
    loss.backward()
    torch.cuda.synchronize()
    after = _counts()
    assert bool(torch.isfinite(loss))
    fwd, bwd = (now - then for now, then in zip(_by_width(), widths))
    return (after[0] - before[0], after[1] - before[1]), (dict(fwd),
                                                          dict(bwd))


@pytest.mark.gpu
def test_mae_vitb_step_launches(cuda):
    """A MAE ViT-B step in bf16 (B = 4): 42 forward and 42 backward
    launches, 25 at the encoder's width 768 (12 blocks x 2 + norm) and 17
    at the decoder's 512 (8 blocks x 2 + decoder_norm); in float32,
    none."""
    widths = {768: 25, 512: 17}
    assert _mae_step(torch.bfloat16, cuda) == ((42, 42), (widths, widths))
    assert _mae_step(torch.float32, cuda) == ((0, 0), ({}, {}))


@pytest.mark.gpu
def test_no_grad_forward_saves_nothing(cuda):
    """Under no_grad (the MoCo momentum encoder, eval) the route launches
    the forward alone and the output has no graph."""
    x, _, w, b = _inputs(64, 768, cuda)
    ln = torch.nn.LayerNorm(768, eps=EPS).to(cuda)
    before = _counts()
    with torch.no_grad():
        y = layers.layer_norm(x.reshape(8, 8, 768), ln, torch.bfloat16)
    assert y.grad_fn is None and y.shape == (8, 8, 768)
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
