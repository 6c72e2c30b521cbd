"""The port's fused MLP (`ssl4gie_tpu_torch/kernels/fused_mlp.py`) against
the JAX package's Pallas kernels (interpret mode on the CPU) on the same
inputs, the `Mlp` route in both packages with the flag on, and the route's
conditions. On CPU tensors the wrappers run their plain versions; the CUDA
kernels themselves are checked by the `gpu`-marked tests (skipped without a
card) and by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.kernels import _build
from ssl4gie_tpu_torch.kernels import fused_mlp as fm
from ssl4gie_tpu_torch.models import layers

torch.set_num_threads(1)

M, C, H = 256, 128, 512          # as tests/test_fused_mlp.py
TWO_ULPS = 2.0 ** -6             # two bf16 ulps, as the attention kernels


@pytest.fixture()
def tensors():
    """The JAX kernel test's draws: x (2, 128, C), w1 (C, H), b1, w2 (H, C),
    b2, float32."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, M // 2, C)).astype(np.float32)
    w1 = rng.normal(0, 0.05, (C, H)).astype(np.float32)
    b1 = rng.normal(0, 0.02, (H,)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (H, C)).astype(np.float32)
    b2 = rng.normal(0, 0.02, (C,)).astype(np.float32)
    return x, w1, b1, w2, b2


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


@pytest.mark.parametrize("approximate", [True, False])
def test_fused_mlp_forward_matches_pallas(tensors, approximate, no_build):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.fused_mlp import fused_mlp
    with pltpu.force_tpu_interpret_mode():
        ref = fused_mlp(*map(jnp.asarray, tensors), approximate)
    n = fm.mlp_fwd.launches
    out = fm.fused_mlp(*map(torch.from_numpy, tensors), approximate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    assert fm.mlp_fwd.launches == n


@pytest.mark.parametrize("approximate", [True, False])
def test_fused_mlp_gradients_match_pallas(tensors, approximate, no_build):
    """All five gradients of sum(y * cos(y)) against the Pallas custom VJP."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.fused_mlp import fused_mlp

    def loss(*args):
        y = fused_mlp(*args, approximate)
        return jnp.sum(y * jnp.cos(y))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, tensors))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in tensors]
    y = fm.fused_mlp(*ts, approximate)
    torch.sum(y * torch.cos(y)).backward()
    for t, r, name in zip(ts, ref, ("dx", "dw1", "db1", "dw2", "db2")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("approximate", [True, False])
def test_mlp_wrappers_match_pallas_kernels(tensors, approximate, no_build):
    """The explicit wrappers on CPU tensors: `mlp_fwd` (y, h) against
    `_mlp_fwd` and `mlp_bwd` (dh, g) against `_mlp_bwd_fused`, float32; no
    launch is counted."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.kernels.fused_mlp import _mlp_bwd_fused, _mlp_fwd
    x, w1, b1, w2, b2 = tensors
    x2 = x.reshape(-1, C)
    dy = np.random.default_rng(1).normal(0, 1, (M, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        y_ref, h_ref = _mlp_fwd(*map(jnp.asarray, (x2, w1, b1, w2, b2)),
                                approximate=approximate)
        dh_ref, g_ref = _mlp_bwd_fused(h_ref, jnp.asarray(dy),
                                       jnp.asarray(w2),
                                       approximate=approximate)
    counts = (fm.mlp_fwd.launches, fm.mlp_bwd.launches)
    y, h = fm.mlp_fwd(*map(torch.from_numpy, (x2, w1, b1, w2, b2)),
                      approximate)
    dh, g = fm.mlp_bwd(h, torch.from_numpy(dy), torch.from_numpy(w2),
                       approximate)
    for got, ref, name in ((y, y_ref, "y"), (h, h_ref, "h"),
                           (dh, dh_ref, "dh"), (g, g_ref, "g")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == counts


def _spy(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fm.fused_mlp(*args)
    monkeypatch.setattr(layers, "fused_mlp", spy)
    return calls


def test_mlp_module_fused_path_matches_jax(monkeypatch):
    """`Mlp` with the flag on in both packages (the JAX one through the
    Pallas kernel in interpret mode, the port's through the fused route's
    plain version), bfloat16, one weight set: within 2e-2."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssl4gie_tpu.models import layers as jlayers
    x = np.random.default_rng(2).normal(0, 1, (2, 128, 64)).astype(np.float32)
    jmlp = jlayers.Mlp(hidden_dim=256, out_dim=64, dtype=jnp.bfloat16)
    monkeypatch.setattr(jlayers, "_FUSED_MLP", True)
    with pltpu.force_tpu_interpret_mode():
        variables = jmlp.init(jax.random.PRNGKey(0),
                              jnp.asarray(x, jnp.bfloat16))
        ref = jmlp.apply(variables, jnp.asarray(x, jnp.bfloat16))
    p = jax.tree_util.tree_map(np.asarray, variables["params"])

    mlp = layers.Mlp(64, 256, dtype=torch.bfloat16)
    mlp.load_state_dict({
        "fc1.weight": torch.tensor(p["fc1"]["kernel"].T),
        "fc1.bias": torch.tensor(p["fc1"]["bias"]),
        "fc2.weight": torch.tensor(p["fc2"]["kernel"].T),
        "fc2.bias": torch.tensor(p["fc2"]["bias"])})
    monkeypatch.setattr(layers, "FUSED_MLP", True)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        out = mlp(torch.from_numpy(x).to(torch.bfloat16))
    assert calls == [(2, 128, 64)]
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("flag,dtype,tokens,fused", [
    (True, torch.bfloat16, 128, True),
    (True, torch.bfloat16, 2 * 197, False),     # tokens % 128 != 0
    (True, torch.float32, 128, False),          # f32 compute
    (False, torch.bfloat16, 128, False),        # flag off (the default)
])
def test_mlp_routing(monkeypatch, flag, dtype, tokens, fused):
    """The fused route is taken exactly when the flag is on, the compute is
    bfloat16 and the token count is a multiple of 128, as the JAX `Mlp`;
    both routes give the same output on the CPU."""
    monkeypatch.setattr(layers, "FUSED_MLP", flag)
    calls = _spy(monkeypatch)
    mlp = layers.Mlp(64, 256, dtype=dtype)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((tokens // 2, 2, 64), generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    with torch.no_grad():
        out = mlp(x)
        monkeypatch.setattr(layers, "FUSED_MLP", False)
        plain = mlp(x)
    assert len(calls) == int(fused)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_fused_flag_default_off():
    """`SSL4GIE_FUSED_MLP` is read once; unset, the fused route is off."""
    import os
    assert layers.FUSED_MLP == (os.environ.get("SSL4GIE_FUSED_MLP") == "1")


def _card_case(cuda, m, c, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rand = lambda *s, std=1.0: (torch.randn(s, generator=gen, device=cuda)
                                * std).bfloat16()
    # nn.Linear layout (out, in); the wrappers take their (in, out) views
    return (rand(m, c), rand(hd, c, std=c ** -0.5), rand(hd, std=0.02),
            rand(c, hd, std=hd ** -0.5), rand(c, std=0.02), rand(m, c))


def _assert_close_on_card(got, ref, tol=TWO_ULPS):
    """Every element within tol * (|ref| + max|ref|), all finite."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs()
    assert bool((err <= tol * (ref.abs() + ref.abs().max())).all()), \
        (err.max().item(), ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,hd", [
    (12800, 768, 3072),       # MAE encoder
    (50432, 512, 2048),       # MAE decoder
    (300, 128, 512),          # a ragged token count
    (12608, 384, 1536),       # ViT-S widths (B = 64); N tile 192 in (b)
    (256, 768, 3072),         # fewer output tiles than SMs
    (1000, 640, 2560),        # N tile 128 in (b): 640 % 256, 640 % 192
])
@pytest.mark.parametrize("approximate", [True, False])
def test_fused_mlp_kernels_match_plain_on_card(cuda, m, c, hd, approximate):
    x, w1, b1, w2, b2, dy = _card_case(cuda, m, c, hd, 0)
    n0 = (fm.mlp_fwd.launches, fm.mlp_bwd.launches)
    y, h = fm.mlp_fwd(x, w1.t(), b1, w2.t(), b2, approximate)
    y_p, h_p = fm.mlp_fwd_plain(x, w1.t(), b1, w2.t(), b2, approximate)
    _assert_close_on_card(h, h_p)
    _assert_close_on_card(y, y_p)
    dh, g = fm.mlp_bwd(h, dy, w2.t(), approximate)
    dh_p, g_p = fm.mlp_bwd_plain(h, dy, w2.t(), approximate)
    _assert_close_on_card(dh, dh_p)
    _assert_close_on_card(g, g_p)
    assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.gpu
def test_fused_mlp_autograd_matches_plain_on_card(cuda):
    """The autograd Function's five gradients on the card against autograd
    of the plain version, same bf16 inputs."""
    x, w1, b1, w2, b2, dy = _card_case(cuda, 2 * 256, 256, 1024, 1)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    y = fm.fused_mlp(leaves[0].reshape(2, 256, 256), leaves[1].t(), leaves[2],
                     leaves[3].t(), leaves[4])
    y.backward(dy.reshape(2, 256, 256))
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    y_p = fm.fused_mlp_plain(ref_leaves[0], ref_leaves[1].t(), ref_leaves[2],
                             ref_leaves[3].t(), ref_leaves[4])
    y_p.backward(dy)
    _assert_close_on_card(y.reshape(-1, 256), y_p)
    for got, ref in zip(leaves, ref_leaves):
        _assert_close_on_card(got.grad, ref.grad, 2 * TWO_ULPS)


@pytest.mark.gpu
def test_fused_mlp_kernel_rejects_what_it_does_not_take(cuda):
    x, w1, b1, w2, b2, _ = _card_case(cuda, 128, 128, 512, 2)
    with pytest.raises(TypeError):
        fm.mlp_fwd(x.float(), w1.t(), b1, w2.t(), b2)          # f32
    x64, w1_64, b1_64, w2_64, b2_64, _ = _card_case(cuda, 128, 64, 256, 3)
    with pytest.raises(ValueError):
        fm.mlp_fwd(x64, w1_64.t(), b1_64, w2_64.t(), b2_64)    # C = 64


@pytest.mark.gpu
def test_fused_mlp_kernels_repeat_bitwise_on_card(cuda):
    """No atomics and no split-K: two forwards and two backwards of the
    same inputs give the same bits, at the MAE encoder's shape."""
    x, w1, b1, w2, b2, dy = _card_case(cuda, 12800, 768, 3072, 4)
    runs = []
    for _ in range(2):
        y, h = fm.mlp_fwd(x, w1.t(), b1, w2.t(), b2)
        dh, g = fm.mlp_bwd(h, dy, w2.t())
        runs.append((y, h, dh, g))
    torch.cuda.synchronize()
    for first, second, name in zip(*runs, ("y", "h", "dh", "g")):
        assert torch.equal(first, second), name
