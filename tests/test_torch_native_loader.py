"""The port's C++ loader (`ssl4gie_tpu_torch/data/native_loader.py`, its
own copy of `native/loader.cpp`) against the JAX package's bindings on the
same files: `load` and `augment_classification` bitwise for the same seed,
against PIL as `tests/test_native_loader.py` holds the JAX one, the
missing-file IOError, the `SSL4GIE_NATIVE_LOADER=1` route of `Loader`
byte-equal to JAX's, the `SSL4GIE_HOST_AUG=1` route of `Trainer`, and a
failed build that raises with the compiler's message."""


import numpy as np
import pytest
import torch
from PIL import Image

from ssl4gie_tpu.data import loader as jloader
from ssl4gie_tpu.data import native_loader as jnative
from ssl4gie_tpu_torch.data import loader as tloader
from ssl4gie_tpu_torch.data import native_loader as tnative

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A JPEG, a PNG and an RGBA PNG of a smooth 230 x 310 image, and one
    of 97 x 61 (upsampled)."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (12, 16, 3))
    img = np.kron(base, np.ones((20, 20, 1)))[:230, :310].astype(np.uint8)
    paths = [str(d / "a.jpg"), str(d / "b.png"), str(d / "c.png"),
             str(d / "d.jpg")]
    Image.fromarray(img).save(paths[0], quality=95)
    Image.fromarray(img).save(paths[1])
    Image.fromarray(np.dstack([img, np.full(img.shape[:2], 200, np.uint8)]),
                    "RGBA").save(paths[2])
    Image.fromarray(rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)).save(
        paths[3], quality=90)
    return paths, img


@pytest.fixture(scope="module")
def loaders():
    return (tnative.NativeBatchLoader(num_threads=2),
            jnative.NativeBatchLoader(num_threads=2))


@pytest.mark.parametrize("size,square", [(224, False), (64, True),
                                         (300, False)])
def test_load_matches_jax_bitwise(images, loaders, size, square):
    port, jax_loader = loaders
    paths, _ = images
    out = port.load(paths, size, square)
    ref = jax_loader.load(paths, size, square)
    assert out.shape == (len(paths), size, size, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_load_against_pil(images, loaders):
    """Decode and resize near PIL's bilinear (the JAX loader's bounds)."""
    paths, _ = images
    out = loaders[0].load(paths[:2], 224)
    for i, path in enumerate(paths[:2]):
        with Image.open(path) as im:
            ref = np.asarray(im.convert("RGB").resize((224, 224),
                                                      Image.BILINEAR))
        diff = np.abs(out[i].astype(np.float32) - ref)
        assert diff.mean() < 3.0 and np.percentile(diff, 99) < 30


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
def test_augment_classification_matches_jax_bitwise(loaders, seed):
    imgs = np.random.default_rng(seed % 97).integers(0, 256, (6, 64, 64, 3),
                                                     dtype=np.uint8)
    out = tnative.augment_classification(loaders[0], imgs, seed)
    ref = jnative.augment_classification(loaders[1], imgs, seed)
    assert out.shape == imgs.shape and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    other = tnative.augment_classification(loaders[0], imgs, seed + 1)
    assert np.abs(out - other).max() > 0.1


def test_missing_file_raises(loaders):
    with pytest.raises(IOError, match="zzz.jpg"):
        loaders[0].load(["/nonexistent/zzz.jpg"], 64)


def test_library_is_the_ports_own_build():
    """Built from the port's copy into the git-ignored build directory,
    under the hash of the source and the command; the copy keeps the JAX
    package's C entry points."""
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path == tnative.library_path()
    assert "native" not in path.parent.name
    src = tnative.SOURCE.read_text()
    for name in ("s4g_pool_create", "s4g_load_batch",
                 "s4g_augment_classification", "s4g_pool_destroy"):
        assert f" {name}(" in src


@pytest.mark.parametrize("native", ["1", "0"])
def test_loader_route_matches_jax(images, monkeypatch, native):
    """`Loader` batches of `ClassificationSource` under the env switch,
    byte-equal to the JAX package's (its native route with "1", PIL
    with "0")."""
    paths, _ = images
    monkeypatch.setenv("SSL4GIE_NATIVE_LOADER", native)
    labels = [0, 1, 2, 1]
    mine = tloader.Loader(tloader.ClassificationSource(paths, labels, 96), 2,
                          shuffle=True, seed=3, num_threads=2)
    ref = jloader.Loader(jloader.ClassificationSource(paths, labels, 96), 2,
                         shuffle=True, seed=3, num_threads=2)
    for a, b in zip(mine.epoch(1), ref.epoch(1), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if native == "1":
        assert tloader._native is not None


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: `library()` raises with g++'s
    message, and so does the Loader route that asks for it (no PIL)."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("int s4g_pool_create( {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tloader, "_native", None)
    with pytest.raises(RuntimeError, match="native loader build failed"
                       "(.|\n)*error"):
        tnative.library()
    monkeypatch.setenv("SSL4GIE_NATIVE_LOADER", "1")
    with pytest.raises(RuntimeError, match="native loader build failed"):
        tloader._open_rgb(str(bad), 32)
    monkeypatch.setattr(tnative, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        tnative.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_library_load_raises(images, tmp_path, monkeypatch):
    """A library that builds but does not load (a shared library of its
    own missing at run time): the Loader route raises the OSError, and
    does not decode the file through PIL instead."""
    def no_libjpeg(path):
        raise OSError("libjpeg.so.8: cannot open shared object file")

    monkeypatch.setattr(tnative, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(tnative.ctypes, "CDLL", no_libjpeg)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tloader, "_native", None)
    monkeypatch.setenv("SSL4GIE_NATIVE_LOADER", "1")
    with pytest.raises(OSError, match="libjpeg"):
        tloader._open_rgb(images[0][1], 32)
    assert tloader._native is None


def test_host_aug_route_of_the_trainer(monkeypatch, tmp_path):
    """With SSL4GIE_HOST_AUG=1 a classification epoch trains on the C++
    pool's augmentation, seeded from the epoch's generator: the step sees
    exactly `augment_classification` of the Loader's batches."""
    from ssl4gie_tpu_torch.core import trainer as ttrainer
    from ssl4gie_tpu_torch.core.checkpoint import CheckpointManager
    from ssl4gie_tpu_torch.core.logger import MetricsLogger
    from ssl4gie_tpu_torch.data.loader import Loader, SyntheticSource
    from ssl4gie_tpu_torch.core.train_state import make_adamw

    seen = []

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 6)

        def forward(self, x, generator=None):
            seen.append(x.clone())
            return self.lin(x.mean(dim=(1, 2)))

    task = ttrainer.TaskDefinition(
        name="classification", aug_mode="classification",
        target_key="label",
        loss_fn=lambda out, y: torch.nn.functional.cross_entropy(
            out, y.long()))
    net = Net()
    loader = Loader(SyntheticSource(8, 32, "classification"), 4, seed=1,
                    num_threads=2)
    t = ttrainer.Trainer(task=task, model=net,
                         optimizer=make_adamw(net.parameters(), 1e-3),
                         device="cpu", train_loader=loader, val_loader=None,
                         test_loader=None,
                         logger=MetricsLogger(str(tmp_path), "run"),
                         ckpt=CheckpointManager(str(tmp_path), "run"),
                         epochs=1, seed=5, log_every=1)
    monkeypatch.setenv("SSL4GIE_HOST_AUG", "1")
    t.train_epoch(2)
    gen = t.generators(2)[0]
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist()
    pool = tnative.NativeBatchLoader(num_threads=2)
    for x, batch, seed in zip(seen, loader.epoch(2), seeds, strict=True):
        np.testing.assert_array_equal(x.numpy(), tnative.augment_classification(
            pool, batch["image"], seed))
    monkeypatch.setenv("SSL4GIE_HOST_AUG", "0")
    seen.clear()
    t.train_epoch(2)
    assert len(seen) == 2 and not np.array_equal(
        seen[0].numpy(), tnative.augment_classification(
            pool, next(loader.epoch(2))["image"], seeds[0]))
