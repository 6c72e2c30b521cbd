"""The port's classification augmentation (`ssl4gie_tpu_torch/data/augment.py`)
against the JAX package's, in float32 on the CPU: each op at explicit
parameters, then the whole pipeline with the parameters that
`augment_train_batch` drew (the JAX key splits are replayed here), then the
port's own sampler against the JAX ranges by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.data import augment as jaug
from ssl4gie_tpu_torch.data import augment as taug

torch.set_num_threads(1)

B, S = 4, 224
TOL = 1e-5


def jax_classification_params(key, batch: int) -> dict:
    """The factors `augment_train_batch(key, img, mode="classification")`
    draws, replaying its key splits (`_augment_train_batch`, `color_jitter`,
    `gaussian_blur`, `random_flips`), as the port's parameter dict."""
    kj, kb, kf, ka = jax.random.split(key, 4)
    kbr, kc, ks, kh, ko = jax.random.split(kj, 5)
    u = lambda k, shape, lo, hi: np.asarray(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(batch)
    khf, kvf = jax.random.split(kf)
    flip = lambda k: np.asarray(jax.random.uniform(k, (batch, 1, 1, 1))
                                > 0.5).reshape(batch)
    p = {"brightness": u(kbr, (batch, 1, 1, 1), 1 - 0.4, 1 + 0.4),
         "contrast": u(kc, (batch, 1, 1, 1), 1 - 0.5, 1 + 0.5),
         "saturation": u(ks, (batch, 1, 1, 1), 1 - 0.25, 1 + 0.25),
         "hue": u(kh, (batch, 1, 1), -0.01, 0.01),
         "sigma": u(kb, (batch, 1), 0.001, 2.0),
         "hflip": flip(khf), "vflip": flip(kvf),
         "angle": u(ka, (batch,), -180.0, 180.0)}
    p = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    p["order"] = np.asarray(jax.random.permutation(ko, 4)).tolist()
    return p


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(0).random((B, S, S, 3)).astype(np.float32)


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("op,factors", [
    ("_adjust_brightness", (0.6, 1.0, 1.3, 1.4)),
    ("_adjust_contrast", (0.5, 0.9, 1.2, 1.5)),
    ("_adjust_saturation", (0.75, 1.0, 1.1, 1.25)),
])
def test_jitter_ops_match_jax(img, op, factors):
    f = np.asarray(factors, np.float32).reshape(B, 1, 1, 1)
    ref = getattr(jaug, op)(jnp.asarray(img), jnp.asarray(f))
    _close(getattr(taug, op)(torch.from_numpy(img), torch.from_numpy(f)), ref)


def test_adjust_hue_matches_jax(img):
    # exact HSV round trip; include grey and saturated pixels
    x = img.copy()
    x[0, :8] = 0.5
    x[1, :8] = [1.0, 0.0, 0.0]
    f = np.asarray([-0.01, 0.0, 0.004, 0.01], np.float32).reshape(B, 1, 1)
    ref = jaug._adjust_hue(jnp.asarray(x), jnp.asarray(f))
    _close(taug._adjust_hue(torch.from_numpy(x), torch.from_numpy(f)), ref)


def test_gaussian_blur_matches_jax(img):
    sigma = np.asarray([0.001, 0.5, 1.3, 2.0], np.float32)
    key = jax.random.PRNGKey(3)
    # gaussian_blur draws sigma from its key; hand the port that same draw
    drawn = np.asarray(jax.random.uniform(key, (B, 1), minval=0.001,
                                          maxval=2.0)).reshape(B).copy()
    ref = jaug.gaussian_blur(key, jnp.asarray(img))
    _close(taug.gaussian_blur(torch.from_numpy(img), torch.from_numpy(drawn)),
           ref)
    # explicit sigmas through the weights both packages build
    xs = np.arange(-12, 13, dtype=np.float32)[None, :]
    w = np.exp(-0.5 * (xs / sigma[:, None]) ** 2)
    w = w / w.sum(axis=1, keepdims=True)
    _close(taug.blur_weights(torch.from_numpy(sigma)), w, 1e-6)


def test_flips_match_jax_exactly(img):
    key = jax.random.PRNGKey(5)
    ref, _ = jaug.random_flips(key, jnp.asarray(img))
    kh, kv = jax.random.split(key)
    do = lambda k: torch.from_numpy(np.array(
        jax.random.uniform(k, (B, 1, 1, 1)) > 0.5).reshape(B))
    out = taug.random_flips(torch.from_numpy(img), do(kh), do(kv))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# Pixels whose shear shift lands within f32 rounding of a .5 tie: XLA's and
# torch's f32 tan/sin may differ in the last bit there, and then the two
# round the shift to neighbouring integers. Bound that at 0.1% of pixels.
TIE_SHARE = 1e-3


@pytest.mark.parametrize("angles", [
    (0.0, 90.0, -90.0, 180.0),
    (-180.0, 45.0, -135.0, 10.0),
    (33.3, -77.7, 123.4, -4.2),
])
def test_rotate_nearest_shear_matches_jax(img, angles):
    a = np.asarray(angles, np.float32)
    ref = np.asarray(jaug.rotate_nearest_shear(jnp.asarray(img),
                                               jnp.asarray(a)))
    out = taug.rotate_nearest_shear(torch.from_numpy(img),
                                    torch.from_numpy(a)).numpy()
    assert np.mean(np.any(out != ref, axis=-1)) <= TIE_SHARE


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_matches_augment_train_batch(seed):
    rng = np.random.default_rng(seed)
    img_u8 = rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    ref, _ = jaug.augment_train_batch(key, jnp.asarray(img_u8),
                                      mode="classification", exact=False,
                                      per_image_jitter=False)
    ref = np.asarray(ref)
    out = taug.apply_classification(torch.from_numpy(img_u8),
                                    jax_classification_params(key, B)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    # 1e-5 on the [0, 1] image is 5e-5 after dividing by std >= 0.224
    bad = np.any(np.abs(out - ref) > 5e-5, axis=-1)
    assert np.mean(bad) <= TIE_SHARE


def test_eval_batch_matches_jax():
    img_u8 = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), np.uint8)
    _close(taug.eval_batch(torch.from_numpy(img_u8)),
           jaug.eval_batch(jnp.asarray(img_u8)))


def test_sampler_matches_jax_ranges():
    """Each factor of the port's sampler against the same factor drawn by the
    JAX key splits, by distribution: the same support and quantiles within
    3% of the range (4096 draws each)."""
    n = 4096
    mine = taug.sample_classification_params(
        n, torch.Generator().manual_seed(0))
    ref = jax_classification_params(jax.random.PRNGKey(0), n)
    for name, (lo, hi) in {"brightness": (0.6, 1.4), "contrast": (0.5, 1.5),
                           "saturation": (0.75, 1.25), "hue": (-0.01, 0.01),
                           "sigma": (0.001, 2.0),
                           "angle": (-180.0, 180.0)}.items():
        m, r = mine[name].numpy(), ref[name].numpy()
        assert m.shape == (n,) and lo <= m.min() and m.max() <= hi, name
        qs = np.linspace(0.05, 0.95, 10)
        np.testing.assert_allclose(np.quantile(m, qs), np.quantile(r, qs),
                                   atol=0.03 * (hi - lo), err_msg=name)
    for name in ("hflip", "vflip"):
        assert mine[name].dtype == torch.bool
        assert abs(mine[name].float().mean().item() - 0.5) < 0.03, name
    assert sorted(mine["order"]) == [0, 1, 2, 3]
    orders = {tuple(taug.sample_classification_params(
        1, torch.Generator().manual_seed(s))["order"]) for s in range(200)}
    assert len(orders) > 12      # the order varies between draws
