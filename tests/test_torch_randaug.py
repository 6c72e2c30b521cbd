"""The port's timm stack (`ssl4gie_tpu_torch/data/randaug.py`) against the
JAX package's on the CPU: the policy grammar, each of the 15 ops, the
geometric matrices, one full RandAugment layer, the random erasing, the
probe transform and the whole timm train batch, each at the values that
the JAX function's own key draws produce, rebuilt here and handed to the
port; the port's samplers by distribution. Images are float32 in [0, 255]
(B = 4-16, 24-48 px)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.data import randaug as jra
from ssl4gie_tpu_torch.data import randaug as tra
from ssl4gie_tpu_torch.data.ssl_augment import crop_boxes

torch.set_num_threads(1)


def _img(B=4, H=24, W=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, H, W, 3)).astype(np.float32)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("policy", ["rand-m9-mstd0.5-inc1", "rand-m7-n3-p0.7",
                                    "rand-m10", "augmix-m3", "rand-x3"])
def test_parse_policy(policy):
    try:
        want = jra.parse_rand_augment(policy)
    except ValueError:
        with pytest.raises(ValueError):
            tra.parse_rand_augment(policy)
        return
    assert tra.parse_rand_augment(policy) == want


# every op's argument per image, chosen to cover the LUT edges
BITS = np.array([0, 1, 4, 8], np.int32)
THRESH = np.array([0.0, 26.0, 128.0, 256.0], np.float32)
ADD = np.array([0.0, 11.0, 99.0, 110.0], np.float32)
FACTORS = np.array([0.1, 0.55, 1.0, 1.9], np.float32)


def _photometric(mod, x, arr):
    """{op: output} of the ten photometric ops of `mod` on x."""
    f4 = arr(FACTORS).reshape(-1, 1, 1, 1)
    return {"auto_contrast": mod.auto_contrast(x),
            "equalize": mod.equalize(x), "invert": mod.invert(x),
            "posterize": mod.posterize(x, arr(BITS)),
            "solarize": mod.solarize(x, arr(THRESH)),
            "solarize_add": mod.solarize_add(x, arr(ADD)),
            "color": mod.adjust_color(x, f4),
            "contrast": mod.adjust_contrast(x, f4),
            "brightness": mod.adjust_brightness(x, f4),
            "sharpness": mod.adjust_sharpness(x, f4)}


INTEGER_OPS = ("auto_contrast", "equalize", "invert", "posterize", "solarize",
               "solarize_add")


@pytest.mark.parametrize("op", INTEGER_OPS + ("color", "contrast",
                                              "brightness", "sharpness"))
def test_photometric_op_matches_jax(op):
    """The integer ops bitwise, the blends within 1e-5; an image with a
    flat channel and a narrow range too (autocontrast's identity and
    stretch, equalize's step)."""
    x = _img(seed=3)
    x[1, :, :, 0] = 77.0
    x[2] = np.clip(x[2], 40, 90)
    want = _np(_photometric(jra, jnp.asarray(x), jnp.asarray)[op])
    got = _photometric(tra, torch.from_numpy(x), _t)[op].numpy()
    if op in INTEGER_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _layer_draws(key, B, cfg):
    """The draws of JAX `_rand_augment_layer(key, ...)`, as the port's
    layer dict."""
    kop, kap, kmag, ksgn = jax.random.split(key, 4)
    return {"op": _t(jax.random.randint(kop, (B,), 0, 15)).long(),
            "applied": _t(jax.random.uniform(kap, (B,)) < cfg["prob"]),
            "mag": _t(jnp.clip(cfg["magnitude"] + cfg["mstd"]
                               * jax.random.normal(kmag, (B,)), 0.0, 10.0)),
            "sign": _t(jnp.where(jax.random.uniform(ksgn, (B,)) > 0.5,
                                 -1.0, 1.0))}


@pytest.mark.parametrize("op", jra._GEO_OPS)
def test_geometric_op_matches_jax(op):
    """Each geometric op alone (every image applied, magnitudes and signs
    across the range): the matrix within 1e-6 and the warp requantized to
    uint8 values, as the layer does, equal."""
    B = 6
    x = _img(B=B, H=20, W=28, seed=op)
    ops = np.full(B, op, np.int32)
    applied = np.array([1, 1, 1, 1, 1, 0], bool)
    mag = np.array([0.0, 2.5, 5.0, 9.0, 10.0, 9.0], np.float32)
    sign = np.array([1, -1, 1, -1, 1, 1], np.float32)
    jm = jra._geo_matrix(jnp.asarray(ops), jnp.asarray(applied),
                         jnp.asarray(mag), jnp.asarray(sign), 20, 28)
    tm = tra._geo_matrix(_t(ops).long(), _t(applied), _t(mag), _t(sign), 20,
                         28)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=0, atol=1e-6)
    from ssl4gie_tpu.data.augment import affine_sample as jaffine
    from ssl4gie_tpu_torch.data.augment import affine_sample as taffine
    want = jnp.clip(jnp.floor(jaffine(jnp.asarray(x), jm, fill=jra.FILL,
                                      mode="bilinear") + 0.5), 0.0, 255.0)
    got = torch.clamp(torch.floor(taffine(torch.from_numpy(x), tm, tra.FILL,
                                          "bilinear") + 0.5), 0.0, 255.0)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(got[-1].numpy(), x[-1])   # not applied


@pytest.mark.parametrize("increasing", [True, False])
def test_rand_augment_layer_matches_jax(increasing):
    """One full layer over B = 16 images at JAX's draws (every op at
    least once across the seeds' batch), at prob 1 so that all apply."""
    B = 16
    cfg = dict(magnitude=9.0, num_layers=1, prob=1.0, mstd=0.5,
               increasing=increasing)
    x = _img(B=B, H=24, W=24, seed=11)
    key = jax.random.PRNGKey(5)
    want = _np(jra._rand_augment_layer(key, jnp.asarray(x), cfg["magnitude"],
                                       cfg["mstd"], cfg["prob"], increasing))
    layer = _layer_draws(key, B, cfg)
    got = tra.rand_augment_layer(torch.from_numpy(x), layer, increasing)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _crop_draws(key, B, H, W, scale):
    """The box of JAX `random_resized_crop(key, ...)`."""
    ka, kr, kx, ky = jax.random.split(key, 4)
    area = _t(jax.random.uniform(ka, (B,), minval=scale[0], maxval=scale[1]))
    log_r = _t(jax.random.uniform(kr, (B,), minval=jnp.log(3 / 4),
                                  maxval=jnp.log(4 / 3)))
    ux, uy = (_t(jax.random.uniform(k, (B,))) for k in (kx, ky))
    return crop_boxes(area, log_r, ux, uy, H, W)


def _erase_draws(key, B, shape):
    """The draws of JAX `random_erasing(key, ...)` and its noise."""
    ka, kr, kt, kl, kp, kn = jax.random.split(key, 6)
    A = 10
    params = {
        "area": _t(jax.random.uniform(ka, (B, A), minval=0.02,
                                      maxval=1 / 3)),
        "log_r": _t(jax.random.uniform(kr, (B, A), minval=jnp.log(0.3),
                                       maxval=jnp.log(1.0 / 0.3))),
        "top": _t(jax.random.uniform(kt, (B,))),
        "left": _t(jax.random.uniform(kl, (B,))),
        "coin": _t(jax.random.uniform(kp, (B,)))}
    return params, _t(jax.random.normal(kn, shape, jnp.float32))


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_random_erasing_matches_jax(prob):
    B, H = 16, 24
    v = np.random.default_rng(2).normal(size=(B, H, H, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = _np(jra.random_erasing(key, jnp.asarray(v), prob))
    params, noise = _erase_draws(key, B, v.shape)
    boxes = tra.erase_boxes(params, prob, H, H)
    got = tra.random_erasing(torch.from_numpy(v), boxes, noise)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != v).any()


def test_probe_train_batch_matches_jax():
    B, H, S = 4, 40, 32
    img = _img(B=B, H=H, W=H, seed=4).astype(np.uint8)
    key = jax.random.PRNGKey(1)
    want = _np(jra.probe_train_batch(key, jnp.asarray(img), out_size=S))
    kc, kf = jax.random.split(key)
    params = {"box": _crop_draws(kc, B, H, H, (0.08, 1.0)),
              "flip": _t(jax.random.uniform(kf, (B, 1, 1, 1)) > 0.5)[:, 0, 0,
                                                                    0]}
    got = tra.probe_train_batch(torch.from_numpy(img), params, S)
    # JAX crops by two interpolation matmuls, the port by two-tap gathers:
    # the same two products a pixel, summed in another order (a few 1e-6
    # in [0, 1], over the std 0.225 after normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("policy,reprob", [("rand-m9-mstd0.5-inc1", 0.25),
                                           ("rand-m9-mstd0.5-inc1", 1.0),
                                           ("", 0.5)])
def test_timm_train_batch_matches_jax(policy, reprob):
    """The whole stack at JAX's draws, the erasing noise JAX's."""
    B, H, S = 8, 40, 32
    img = _img(B=B, H=H, W=H, seed=6).astype(np.uint8)
    key = jax.random.PRNGKey(12)
    want = _np(jra.timm_train_batch(key, jnp.asarray(img), out_size=S,
                                    policy=policy, reprob=reprob))
    kc, kf, ka, ke = jax.random.split(key, 4)
    params = {"box": _crop_draws(kc, B, H, H, (0.08, 1.0)),
              "flip": _t(jax.random.uniform(kf, (B, 1, 1, 1))
                         > 0.5)[:, 0, 0, 0],
              "reprob": reprob, "ra": [], "increasing": False}
    if policy:
        cfg = jra.parse_rand_augment(policy)
        params["increasing"] = cfg["increasing"]
        params["ra"] = [_layer_draws(k, B, cfg)
                        for k in jax.random.split(ka, cfg["num_layers"])]
    params["erase"], noise = _erase_draws(ke, B, (B, S, S, 3))
    got = tra.timm_train_batch(torch.from_numpy(img), params, S, noise=noise)
    assert_one_level(got.numpy(), want, LEVEL_SHARE)


# The crop is requantized to uint8 values (PIL's crop), floor(v + 0.5): the
# crop's two products a pixel, summed in another order than JAX's matmuls
# (a few 1e-6 apart), round the other way where v sits at .5 within that.
# Such a pixel is one level (1/255 over the channel's std) off, and so may
# be what the RandAugment ops make of it; allowed on this share of values.
LEVEL_SHARE = 1e-3


def assert_one_level(got, want, share):
    """All of `got` within 1e-5 of `want` except at most `share` of the
    values, which are within one uint8 level after normalize."""
    level = 1.0 / 255.0 / min(0.229, 0.224, 0.225)
    diff = np.abs(got - want)
    off = diff > 1e-5
    assert off.mean() <= share, f"{off.mean():.2e} of the values differ"
    assert diff.max() <= level * 1.001, diff.max()


def test_samplers_by_distribution():
    """The port's draws have JAX's distributions: ops uniform over 15, the
    coin at prob, N(9, 0.5) magnitudes clipped to [0, 10], fair signs; the
    erasing's area fractions U[0.02, 1/3), log aspects U[log 0.3, -log
    0.3) and unit draws; the timm batch's parts."""
    gen = torch.Generator().manual_seed(0)
    cfg = tra.parse_rand_augment("rand-m9-mstd0.5-inc1")
    N = 60000
    (layer, layer2) = tra.sample_rand_augment(N, gen, cfg)
    counts = np.bincount(layer["op"].numpy(), minlength=15) / N
    assert np.abs(counts - 1 / 15).max() < 0.006
    assert abs(layer["applied"].float().mean().item() - 0.5) < 0.01
    mag = layer["mag"].numpy()
    assert mag.min() >= 0 and mag.max() <= 10
    assert abs(mag.mean() - 9.0) < 0.01 and abs(mag.std() - 0.5) < 0.01
    assert abs((layer["sign"] < 0).float().mean().item() - 0.5) < 0.01
    assert not torch.equal(layer["op"], layer2["op"])
    er = tra.sample_erasing(N, gen)
    area = er["area"].numpy()
    assert area.min() >= 0.02 and area.max() < 1 / 3
    assert abs(area.mean() - (0.02 + 1 / 3) / 2) < 0.003
    lr = er["log_r"].numpy()
    assert lr.min() >= np.log(0.3) - 1e-6 and lr.max() < -np.log(0.3)
    assert abs(lr.mean()) < 0.01
    for k in ("top", "left", "coin"):
        assert abs(er[k].mean().item() - 0.5) < 0.01
    p = tra.sample_timm_params(8, 40, gen, "rand-m9-mstd0.5-inc1", 0.25)
    assert p["box"].shape == (8, 4) and len(p["ra"]) == 2
    assert isinstance(p["noise_seed"], int) and p["increasing"]
    assert "erase" not in tra.sample_timm_params(8, 40, gen, "", 0.0)


def test_timm_batch_is_a_function_of_the_generator():
    """Two generators in the same state give the same batch (noise
    included); the erasing noise comes from the seed drawn."""
    img = torch.from_numpy(_img(B=4, H=40, W=40, seed=8).astype(np.uint8))
    aug = tra.make_timm_aug(32, "rand-m9-mstd0.5-inc1", 1.0)
    a = aug(img, torch.Generator().manual_seed(3))
    b = aug(img, torch.Generator().manual_seed(3))
    c = aug(img, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (4, 32, 32, 3)
