"""MoCo v3's transfer datasets and transforms in the port
(`ssl4gie_tpu_torch/data/transfer.py`) against the JAX package's on the
CPU: the three sources on CIFAR pickles, `.mat` files and JPEGs written
here (the JAX package's own test trees), `build_transfer_dataset` and its
refusals, the eval transform within 1e-5 (CIFAR upsampled to the load
size, and a square already at it), the train transform at the draws of
JAX's key, and the port's sampler by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.data import transfer as jtr
from ssl4gie_tpu_torch.data import transfer as ttr
from ssl4gie_tpu_torch.data.ssl_augment import crop_boxes
from test_transfer import (_write_cifar10, _write_cifar100, _write_flowers,
                           _write_pets)

torch.set_num_threads(1)

SIZE = 64   # input size; load size int(256 / 224 * 64) = 73


def _same_source(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a.get(i), b.get(i)
        assert x.keys() == y.keys()
        np.testing.assert_array_equal(x["image"], y["image"])
        assert x["label"] == y["label"] and x["image"].dtype == np.uint8


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "flowers", "pets"])
def test_sources_match_jax(tmp_path, name):
    writer = {"cifar10": _write_cifar10, "cifar100": _write_cifar100,
              "flowers": _write_flowers, "pets": _write_pets}[name]
    writer(str(tmp_path))
    for train in (True, False):
        jsrc, jn = jtr.build_transfer_dataset(name, str(tmp_path), train,
                                              SIZE)
        tsrc, tn = ttr.build_transfer_dataset(name, str(tmp_path), train,
                                              SIZE)
        assert tn == jn and type(tsrc).__name__ == type(jsrc).__name__
        _same_source(tsrc, jsrc)
    if name in ("flowers", "pets"):
        assert tsrc.get(0)["image"].shape == (73, 73, 3)


@pytest.mark.parametrize("name", ["imagenet", "inat"])
def test_build_refusals(tmp_path, name):
    with pytest.raises(NotImplementedError):
        jtr.build_transfer_dataset(name, str(tmp_path), True)
    with pytest.raises(NotImplementedError, match="cifar10, cifar100"):
        ttr.build_transfer_dataset(name, str(tmp_path), True)


@pytest.mark.parametrize("hw", [32, 73])
def test_eval_transform_matches_jax(hw):
    """32 px (CIFAR, resized up to 73 first) and 73 px (Flowers/Pets,
    already at the load size): the centre crop to 64, normalized."""
    img = np.random.default_rng(hw).integers(0, 256, (3, hw, hw, 3),
                                             dtype=np.uint8)
    want = np.asarray(jtr.transfer_eval_batch(jnp.asarray(img), SIZE))
    got = ttr.transfer_eval_batch(torch.from_numpy(img), SIZE)
    assert got.shape == (3, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_train_transform_matches_jax():
    """RandomResizedCrop(scale 0.05-1) + hflip + normalize at the draws of
    JAX's key: the crop's products summed in another order than JAX's
    matmuls (3e-5 after normalize, as the probe transform)."""
    B, H = 6, 73
    img = np.random.default_rng(1).integers(0, 256, (B, H, H, 3),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jtr.transfer_train_batch(key, jnp.asarray(img), SIZE))
    k_crop, k_flip = jax.random.split(key)
    ka, kr, kx, ky = jax.random.split(k_crop, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    box = crop_boxes(
        t(jax.random.uniform(ka, (B,), minval=0.05, maxval=1.0)),
        t(jax.random.uniform(kr, (B,), minval=jnp.log(3 / 4),
                             maxval=jnp.log(4 / 3))),
        t(jax.random.uniform(kx, (B,))), t(jax.random.uniform(ky, (B,))),
        H, H)
    kh, _ = jax.random.split(k_flip)
    flip = t(jax.random.uniform(kh, (B, 1, 1, 1)) > 0.5).reshape(B)
    got = ttr.transfer_train_batch(torch.from_numpy(img),
                                   {"box": box, "flip": flip}, SIZE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    assert flip.any() and not flip.all()


def test_train_sampler_by_distribution():
    """Area fractions U[0.05, 1] (the box's area over the canvas's, before
    clipping to it), fair flips; a function of the generator."""
    N, H = 20000, 73
    p = ttr.sample_transfer_params(N, H, torch.Generator().manual_seed(0))
    box = p["box"].numpy()
    assert box[:, 2].min() >= 1 and box[:, 2].max() <= H
    assert (box[:, 0] >= 0).all() and (box[:, 0] + box[:, 2] <= H + 1e-4).all()
    frac = box[:, 2] * box[:, 3] / (H * H)
    assert frac.min() >= 0.04 and frac.max() <= 1.0 + 1e-6
    assert abs(p["flip"].float().mean().item() - 0.5) < 0.02
    q = ttr.sample_transfer_params(N, H, torch.Generator().manual_seed(0))
    assert torch.equal(q["box"], p["box"])
