"""The port's exact one-pass warp and per-image ColorJitter
(`ssl4gie_tpu_torch/data/augment.py`: `affine_sample`, `random_affine`,
`color_jitter(per_image=True)`, the `exact` pipelines) against the JAX
package's, in float32 on the CPU: each op at explicit parameters, then the
classification and segmentation pipelines of
`_augment_train_batch(exact=True, per_image_jitter=True)` at the factors
and orders its key splits drew (replayed here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.data import augment as jaug
from ssl4gie_tpu_torch.data import augment as taug
from ssl4gie_tpu_torch.kernels import rotate as trot

torch.set_num_threads(1)

B, S = 4, 64
TOL = 1e-5


def _matrices(seed: int, size: int) -> tuple[np.ndarray, dict]:
    """Random affine factors at the reference's ranges and the inverse
    matrices JAX makes of them."""
    rng = np.random.default_rng(seed)
    p = {"angle": rng.uniform(-180, 180, B),
         "translate": rng.uniform(-0.125, 0.125, (B, 2)) * size,
         "scale": rng.uniform(0.5, 1.5, B),
         "shear": rng.uniform(-22.5, 22.5, B)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    m = np.array(jaug._inverse_affine_matrix(
        jnp.asarray(p["angle"]), jnp.asarray(p["translate"]),
        jnp.asarray(p["scale"]), jnp.asarray(p["shear"])))
    return m, {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("seed", [0, 1])
def test_affine_sample_matches_jax(mode, seed):
    """Element for element in f32 at the same matrices, on a non-square
    image (the centers differ per axis), fill -1."""
    m, _ = _matrices(seed, S)
    img = np.random.default_rng(seed + 10).normal(
        size=(B, S, S + 6, 3)).astype(np.float32)
    ref = np.asarray(jaug.affine_sample(jnp.asarray(img), jnp.asarray(m),
                                        -1.0, mode))
    out = taug.affine_sample(torch.from_numpy(img), torch.from_numpy(m),
                             -1.0, mode).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    if mode == "nearest":
        np.testing.assert_array_equal(out, ref)
        assert (out == -1).any() and (out != -1).any()
    else:
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_inverse_matrix_matches_jax():
    m, p = _matrices(3, S)
    out = taug.inverse_affine_matrix(p["angle"], p["translate"], p["scale"],
                                     p["shear"]).numpy()
    np.testing.assert_allclose(out, m, rtol=1e-6, atol=1e-6)


def _jax_affine_factors(key, batch: int, size: int) -> dict:
    """The factors `random_affine(key, ...)` draws, as the port's dict."""
    ka, kt, ks, ksh = jax.random.split(key, 4)
    p = {"angle": jax.random.uniform(ka, (batch,), minval=-180.0,
                                     maxval=180.0),
         "translate": jax.random.uniform(kt, (batch, 2), minval=-0.125,
                                         maxval=0.125)
         * jnp.array([size, size], jnp.float32),
         "scale": jax.random.uniform(ks, (batch,), minval=0.5, maxval=1.5),
         "shear": jax.random.uniform(ksh, (batch,), minval=-22.5,
                                     maxval=22.5)}
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_random_affine_op_matches_jax(mode):
    """`random_affine` at the factors JAX drew: the image (fill -1) and its
    mask (fill 0), element for element (bilinear within 1e-5)."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    mask = (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref_img, ref_mask = jaug.random_affine(key, jnp.asarray(img),
                                           jnp.asarray(mask), mode=mode)
    out_img, out_mask = taug.random_affine(
        torch.from_numpy(img), torch.from_numpy(mask),
        _jax_affine_factors(key, B, S), mode=mode)
    if mode == "nearest":
        np.testing.assert_array_equal(out_img.numpy(), np.asarray(ref_img))
        np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    else:
        np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out_mask.numpy(), np.asarray(ref_mask),
                                   rtol=TOL, atol=TOL)
    assert taug.random_affine(torch.from_numpy(img), None,
                              _jax_affine_factors(key, B, S))[1] is None


def test_per_image_color_jitter_matches_jax():
    """Per-image op orders (four different ones in the batch) at explicit
    factors against JAX's `color_jitter(per_image=True)` fed the same
    draws."""
    img = np.random.default_rng(5).random((B, S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jaug.color_jitter(key, jnp.asarray(img), per_image=True))
    p = _jax_jitter(key, B)
    assert len({tuple(o) for o in p["order"].tolist()}) > 1
    out = taug.color_jitter(torch.from_numpy(img), p["brightness"],
                            p["contrast"], p["saturation"], p["hue"],
                            p["order"], per_image=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    # one order per image equals each image jittered alone in its order
    for b in range(B):
        one = taug.color_jitter(
            torch.from_numpy(img[b:b + 1]), p["brightness"][b:b + 1],
            p["contrast"][b:b + 1], p["saturation"][b:b + 1],
            p["hue"][b:b + 1], p["order"][b].tolist()).numpy()
        np.testing.assert_array_equal(out[b:b + 1], one)


def _jax_jitter(kj, batch: int) -> dict:
    """`color_jitter(kj, ..., per_image=True)`'s draws, as the port's."""
    kb, kc, ks, kh, ko = jax.random.split(kj, 5)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(batch))
    pick = np.asarray(jax.random.randint(ko, (batch,), 0, 24))
    return {"brightness": u(kb, (batch, 1, 1, 1), 0.6, 1.4),
            "contrast": u(kc, (batch, 1, 1, 1), 0.5, 1.5),
            "saturation": u(ks, (batch, 1, 1, 1), 0.75, 1.25),
            "hue": u(kh, (batch, 1, 1), -0.01, 0.01),
            "order": torch.tensor(taug.JITTER_PERMS)[torch.from_numpy(
                pick.astype(np.int64))]}


def _jax_pipeline_params(key, batch: int, size: int, mode: str) -> dict:
    """Every factor `_augment_train_batch(key, ..., mode, exact=True,
    per_image_jitter=True)` draws, replaying its key splits."""
    kj, kb, kf, ka = jax.random.split(key, 4)
    p = _jax_jitter(kj, batch)
    p["sigma"] = torch.from_numpy(np.array(jax.random.uniform(
        kb, (batch, 1), minval=0.001, maxval=2.0)).reshape(batch))
    khf, kvf = jax.random.split(kf)
    for name, k in (("hflip", khf), ("vflip", kvf)):
        p[name] = torch.from_numpy(np.array(
            jax.random.uniform(k, (batch, 1, 1, 1)) > 0.5).reshape(batch))
    if mode == "classification":
        p["angle"] = torch.from_numpy(np.array(jax.random.uniform(
            ka, (batch,), minval=-180.0, maxval=180.0)))
    else:
        p.update(_jax_affine_factors(ka, batch, size))
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_classification_pipeline_matches_jax(seed, monkeypatch):
    """The exact, per-image-jitter classification branch: within 5e-5 of
    the normalized image (1e-5 on [0, 1]) everywhere, and no rotation
    kernel (its wrapper is never called)."""
    rng = np.random.default_rng(seed)
    img_u8 = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    ref, _ = jaug._augment_train_batch(key, jnp.asarray(img_u8),
                                       mode="classification", exact=True,
                                       per_image_jitter=True)
    monkeypatch.setattr(taug, "shear_rotate", _never)
    out = taug.apply_classification(
        torch.from_numpy(img_u8),
        _jax_pipeline_params(key, B, S, "classification"), exact=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-5)


def _never(*args, **kwargs):
    raise AssertionError("the exact route reached the rotation kernel")


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_segmentation_pipeline_matches_jax(seed, monkeypatch):
    """The exact, per-image-jitter segmentation branch: image within 5e-5,
    mask element for element, no rotation kernel."""
    rng = np.random.default_rng(seed)
    img_u8 = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    mask = (rng.random((B, S, S, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_mask = jaug._augment_train_batch(
        key, jnp.asarray(img_u8), jnp.asarray(mask), mode="segmentation",
        exact=True, per_image_jitter=True)
    monkeypatch.setattr(taug, "shear_rotate", _never)
    out_img, out_mask = taug.apply_segmentation(
        torch.from_numpy(img_u8), torch.from_numpy(mask),
        _jax_pipeline_params(key, B, S, "segmentation"), exact=True)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), rtol=0,
                               atol=5e-5)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))


def test_flags_and_per_image_sampler(monkeypatch):
    """The env switches, as the JAX package reads them, and the sampler's
    per-image orders: permutations of 0..3, (B, 4), drawn from all 24."""
    for name in ("SSL4GIE_EXACT_AFFINE", "SSL4GIE_PER_IMAGE_JITTER"):
        monkeypatch.delenv(name, raising=False)
    assert not taug.exact_affine_enabled()
    assert not taug.per_image_jitter_enabled()
    monkeypatch.setenv("SSL4GIE_EXACT_AFFINE", "1")
    monkeypatch.setenv("SSL4GIE_PER_IMAGE_JITTER", "1")
    assert taug.exact_affine_enabled() and jaug.exact_affine_enabled()
    assert taug.per_image_jitter_enabled()
    assert taug.JITTER_PERMS == tuple(map(tuple, jaug._JITTER_PERMS.tolist()))
    p = taug.sample_segmentation_params(512, S, torch.Generator()
                                        .manual_seed(0), per_image_jitter=True)
    order = p["order"]
    assert order.shape == (512, 4)
    assert (order.sort(dim=1).values == torch.arange(4)).all()
    assert len({tuple(o) for o in order.tolist()}) == 24
    batch = taug.sample_classification_params(4, torch.Generator()
                                              .manual_seed(0))
    assert sorted(batch["order"]) == [0, 1, 2, 3]


def test_full_step_reads_the_flags(monkeypatch):
    """`make_full_step` built under SSL4GIE_EXACT_AFFINE=1 takes the exact
    route (no rotation kernel), and without it the Paeth route."""
    from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
    from ssl4gie_tpu_torch.core.train_state import make_adamw

    calls = []
    plain = trot.shear_rotate
    monkeypatch.setattr(taug, "shear_rotate",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label",
                          loss_fn=lambda out, y: out.float().mean())
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 2)

        def forward(self, x, generator=None):
            return self.lin(x.mean(dim=(1, 2)))

    net = Net()
    opt = make_adamw(net.parameters(), 1e-3)
    img = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8)
    labels = torch.zeros(2, dtype=torch.int64)
    for flag, want in (("1", 0), ("0", 1)):
        monkeypatch.setenv("SSL4GIE_EXACT_AFFINE", flag)
        calls.clear()
        make_full_step(task)(net, opt, img, labels,
                             torch.Generator().manual_seed(0))
        assert len(calls) == want, flag
