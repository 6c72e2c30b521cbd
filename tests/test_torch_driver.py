"""The port's finetune driver against the JAX package's, on the CPU, part 1:
what must agree exactly (the config from the same command lines, the flags
the port does not run yet, the split, the three discoveries on a tree of
tiny files, every source byte for byte on PNG, JPG and 16-bit TIFF files,
the synthetic source, the Loader's order, the plateau schedule, the center
crop, the tfevents writer) and the three held-out evaluators
(`tasks/evaluate.py`) on the same weights, with native sizes above and
below the model's input, within 1e-4 absolute, beside the resize that
makes them agree, and the ViT classifier's inverse converter. The
Trainer, fit, resume, preemption and the CLIs are in
`test_torch_trainer.py`.

The evaluators' models are the ResNet-50 family at one block a stage
(`TINY`) at 64 px, with the port's init (random biases and BatchNorm
statistics) handed to JAX by the inverse converters."""

import argparse
import dataclasses
import enum
import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ssl4gie_tpu.cli import args as jargs
from ssl4gie_tpu.core import schedule as jschedule
from ssl4gie_tpu.core import tb as jtb
from ssl4gie_tpu.data import discovery as jdisc
from ssl4gie_tpu.data import loader as jloader
from ssl4gie_tpu.data import splits as jsplits
from ssl4gie_tpu.models import deeplabv3plus as jdl
from ssl4gie_tpu.models import resnet as jres
from ssl4gie_tpu.tasks import evaluate as jeval
from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core import schedule as tschedule
from ssl4gie_tpu_torch.core import tb as ttb
from ssl4gie_tpu_torch.core.config import Architecture, Task
from ssl4gie_tpu_torch.data import discovery as tdisc
from ssl4gie_tpu_torch.data import loader as tloader
from ssl4gie_tpu_torch.data import splits as tsplits
from ssl4gie_tpu_torch.models import factory
from ssl4gie_tpu_torch.ops import resize as tresize
from ssl4gie_tpu_torch.tasks import evaluate as teval
from test_torch_resnet import TINY, randomized

torch.set_num_threads(1)

S = 64                 # the evaluators' model input
EVAL_ATOL = 1e-4


# ----------------------------------------------------------------- config

def parse(pkg_args, argv):
    p = argparse.ArgumentParser()
    pkg_args.add_common(p)
    pkg_args.add_train(p)
    return p.parse_args(argv)


def plain(x):
    """A config as nested plain values (enums by value)."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x.value if isinstance(x, enum.Enum) else x


ARGVS = [
    ["--task", "classification"],
    ["--task", "segmentation", "--arch", "resnet50", "--frozen",
     "--dataset", "Kvasir", "--data-root", "/data/kvasir", "--batch-size",
     "48", "--lrs", "--lrs-min", "1e-7", "--lr", "3e-4", "--seed", "7",
     "--ckpt-dir", "ck", "--tensorboard"],
    ["--task", "depth", "--pretraining", "Hyperkvasir", "--ss-framework",
     "mae", "--learning-rate-scheduler", "false", "--epochs", "3",
     "--out-token", "spatial", "--accum_iter", "2", "--synthetic"],
    ["--task", "classification", "--arch", "resnet50", "--pretraining",
     "ImageNet_self", "--ss-framework", "barlowtwins", "--drop-path", "0"],
    ["--task", "classification", "--drop_path", "0.1", "--out-token",
     "global_pool", "--lrs", "true"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_fields_match_jax(argv):
    """`to_train_config` on the same command line gives the JAX package's
    fields, plus the port's `runtime.device` (the card by default)."""
    want = plain(jargs.to_train_config(parse(jargs, argv)))
    got = plain(targs.to_train_config(parse(
        targs, argv + ["--device", "cpu", "--compute-dtype", "float32"])))
    assert got["runtime"].pop("device") == "cpu"
    want["runtime"]["compute_dtype"] = "float32"
    assert got == want
    default = targs.to_train_config(parse(targs, argv))
    assert default.runtime.device == "cuda"
    assert default.run_name() == jargs.to_train_config(
        parse(jargs, argv)).run_name()


# each flag and the ROADMAP item that it raises naming, or None once the
# port runs it (the SSL recipes and checkpoint ingestion, queue 1 items 5
# and 7; tensor parallelism and FSDP, the multi-GPU slice; float32 on the
# card, the float32 kernels)
UNPORTED = {
    "probe": (["--task", "classification", "--probe", "--pretraining",
               "Hyperkvasir", "--ss-framework", "mae"], None),
    "aa": (["--task", "classification", "--aa", "rand-m9-mstd0.5-inc1"],
           None),
    "reprob": (["--task", "classification", "--reprob", "0.25"], None),
    "mixup": (["--task", "classification", "--mixup", "0.8"], None),
    "cutmix": (["--task", "classification", "--cutmix", "1.0"], None),
    "smoothing": (["--task", "classification", "--smoothing", "0.1"], None),
    "layer-decay": (["--task", "classification", "--layer-decay", "0.65"],
                    None),
    "tensor-parallel": (["--task", "segmentation", "--tp", "2"], None),
    "fsdp": (["--task", "depth", "--fsdp"], None),
    "checkpoint": (["--task", "classification", "--checkpoint", "x.pth",
                    "--pretraining", "Hyperkvasir", "--ss-framework", "mae"],
                   None),
    "imagenet-class": (["--task", "segmentation", "--pretraining",
                        "ImageNet_class"], None),
    "float32-on-card": (["--task", "classification", "--compute-dtype",
                         "float32"], None),
}


@pytest.mark.parametrize("flag", list(UNPORTED))
def test_unported_flags_raise(flag):
    """Each flag the port does not run yet raises NotImplementedError
    naming its ROADMAP item, where the JAX package accepts it; a flag the
    port runs gives the JAX package's config fields (the mesh's and the
    compute dtype too), float32 on the card (the default device) included.
    `--tp 2` in one process fails in both packages' `make_tp_mesh`, on one
    device, with one message."""
    argv, item = UNPORTED[flag]
    want = dataclasses.asdict(jargs.to_train_config(parse(jargs, argv)))
    if item is None:
        cfg = targs.to_train_config(parse(targs, argv))
        got = dataclasses.asdict(cfg)
        for group in ("optim", "data"):
            assert got[group] == want[group]
        for key in ("task", "architecture", "pretraining", "ss_framework",
                    "checkpoint", "probe", "out_token"):
            assert str(got[key]) == str(want[key]), key
        for key in ("tensor_parallel", "fsdp", "mesh_shape", "mesh_axes",
                    "compute_dtype"):
            assert got["runtime"][key] == want["runtime"][key], key
        if flag == "float32-on-card":
            assert got["runtime"]["compute_dtype"] == "float32"
            assert got["runtime"]["device"] == "cuda"
        if flag == "tensor-parallel":
            from ssl4gie_tpu.parallel.tp import make_tp_mesh
            from ssl4gie_tpu_torch.tasks.build import build_trainer
            with pytest.raises(ValueError) as jerr:
                make_tp_mesh(2, 12, devices=jax.devices()[:1])
            with pytest.raises(ValueError, match="does not divide") as terr:
                build_trainer(cfg)
            assert str(terr.value) == str(jerr.value)
        return
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        targs.to_train_config(parse(targs, argv))


@pytest.mark.parametrize("n", [0, 1, 7, 10, 15, 64, 800, 1000, 10662])
def test_split_ids_match_jax(n):
    for a, b in zip(tsplits.split_ids(n), jsplits.split_ids(n)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ----------------------------------------------------------------- files

def _img(path, size, seed, mode="RGB"):
    rng = np.random.default_rng(seed)
    w, h = size
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    im = Image.fromarray(arr)
    if mode == "RGBA":
        im = im.convert("RGBA")
    im.save(path)


def _depth(path, size, seed):
    rng = np.random.default_rng(seed)
    w, h = size
    arr = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    arr[: h // 5] = 0                     # an invalid band
    Image.fromarray(arr).save(path)       # mode I;16


def write_tree(root):
    """Tiny Hyperkvasir, Kvasir-SEG, CVC and C3VD trees."""
    root = str(root)
    hk = os.path.join(root, "hk", "labeled-images")
    for gi in ("lower-gi-tract", "upper-gi-tract"):
        for kind, classes in (("pathological-findings", ("polyps", "ulcer")),
                              ("anatomical-landmarks", ("cecum",))):
            for c in classes:
                d = os.path.join(hk, gi, kind, c)
                os.makedirs(d)
                for i in range(2 + len(c) % 3):
                    _img(os.path.join(d, f"{c}{i}.jpg"), (40, 30), i)
                _img(os.path.join(d, "skip.png"), (8, 8), 9)
    kv = os.path.join(root, "kvasir")
    cvc = os.path.join(root, "cvc")
    for base, im_dir, m_dir in ((kv, "images", "masks"),
                                (cvc, "Original", "Ground Truth")):
        for sub in (im_dir, m_dir):
            os.makedirs(os.path.join(base, sub))
        for i, size in enumerate([(70, 50), (30, 90), (64, 64)]):
            _img(os.path.join(base, im_dir, f"f{i}.jpg"), size, i)
            _img(os.path.join(base, m_dir, f"f{i}.png"), size, 10 + i,
                 mode="L")
    c3 = os.path.join(root, "c3vd")
    vids = ["trans_t2_b_under_review/t2v2", "cecum_t4_b_under_review/c4v3",
            "trans_t4_a_under_review/t4v1", "cecum_t2_c_under_review/c2v3",
            "sigmoid_t1_a/s1v1", "desc_t4_a/d4v1"]
    for j, v in enumerate(vids):
        d = os.path.join(c3, v)
        os.makedirs(d)
        for f in (0, 2, 10, 1):
            _img(os.path.join(d, f"{f}_color.png"), (48, 40), j * 20 + f)
            _depth(os.path.join(d, f"{f}_depth.tiff"), (48, 40), j * 20 + f)
    return os.path.join(root, "hk"), kv, cvc, c3


def test_discoveries_match_jax(tmp_path):
    hk, kv, cvc, c3 = write_tree(tmp_path)
    for ds in ("hyperkvasir-pathological", "hyperkvasir-anatomical"):
        assert dataclasses.asdict(tdisc.discover_classification(hk, ds)) \
            == dataclasses.asdict(jdisc.discover_classification(hk, ds))
    data = tdisc.discover_classification(hk, "x-pathological")
    assert data.n_class == 4 and len(data.input_paths) == 12
    assert tdisc.discover_segmentation(kv, "Kvasir") == \
        jdisc.discover_segmentation(kv, "Kvasir")
    assert tdisc.discover_segmentation(cvc, "CVC") == \
        jdisc.discover_segmentation(cvc, "CVC")
    for numeric in (False, True):
        got = tdisc.discover_depth(c3, numeric_sort=numeric)
        assert got == jdisc.discover_depth(c3, numeric_sort=numeric)
        assert len(got["test"][0]) == len(got["val"][1]) == 8
    assert tdisc.discover_depth(c3, True)["test"][0][:4] != \
        tdisc.discover_depth(c3, False)["test"][0][:4]   # 10 after 2
    for bad in (lambda: tdisc.discover_classification(hk, "other"),
                lambda: tdisc.discover_segmentation(kv, "other")):
        with pytest.raises(ValueError):
            bad()


def _same_samples(a, b, n):
    for i in range(n):
        sa, sb = a.get(i), b.get(i)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert np.asarray(sa[k]).dtype == np.asarray(sb[k]).dtype, k
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_file_sources_match_jax_byte_for_byte(tmp_path):
    """Every file source's samples: JPG and PNG images (RGB, RGBA and
    grayscale converted), PNG masks resized or at their native size, and
    C3VD's 16-bit TIFF depth maps through the make-square path, also with
    the native map."""
    hk, kv, cvc, c3 = write_tree(tmp_path)
    rgba = os.path.join(str(tmp_path), "rgba.png")
    _img(rgba, (33, 21), 3, mode="RGBA")
    data = tdisc.discover_classification(hk, "x-pathological")
    paths = data.input_paths[:3] + [rgba, data.input_paths[3]]
    labels = data.targets[:3] + [1, 2]
    for size in (64, 224):
        _same_samples(tloader.ClassificationSource(paths, labels, size),
                      jloader.ClassificationSource(paths, labels, size), 5)
    imgs, masks = tdisc.discover_segmentation(kv, "Kvasir")
    for native in (False, True):
        _same_samples(
            tloader.SegmentationSource(imgs, masks, 56, native_target=native),
            jloader.SegmentationSource(imgs, masks, 56, native_target=native),
            3)
    assert tloader.SegmentationSource(imgs, masks, 56, True).get(0)[
        "mask"].shape == (50, 70, 1)
    rgb, dep = tdisc.discover_depth(c3, numeric_sort=True)["test"]
    assert Image.open(dep[0]).mode == "I;16"
    for native in (False, True):
        _same_samples(tloader.DepthSource(rgb, dep, 64, with_native=native),
                      jloader.DepthSource(rgb, dep, 64, with_native=native),
                      3)


@pytest.mark.parametrize("task", ["classification", "segmentation", "depth"])
def test_synthetic_source_matches_jax(task):
    for size, seed in ((32, 0), (224, 2)):
        _same_samples(tloader.SyntheticSource(5, size, task, seed=seed),
                      jloader.SyntheticSource(5, size, task, seed=seed), 5)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False),
                                               (False, True)])
def test_loader_order_matches_jax(shuffle, drop_last):
    """The same batches in the same order over three epochs: the
    (seed, epoch) permutation and drop_last."""
    src = tloader.SyntheticSource(21, 8, "classification", seed=1)
    got = tloader.Loader(src, 4, shuffle=shuffle, drop_last=drop_last,
                         seed=5, num_threads=2)
    want = jloader.Loader(src, 4, shuffle=shuffle, drop_last=drop_last,
                          seed=5, num_threads=2)
    assert len(got) == len(want) == (5 if drop_last else 6)
    firsts = []
    for epoch in range(3):
        a, b = list(got.epoch(epoch)), list(want.epoch(epoch))
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        firsts.append(a[0]["label"].tolist())
    assert (firsts[0] != firsts[1]) == shuffle


def test_prefetch_to_device_on_the_cpu():
    src = tloader.SyntheticSource(5, 8, "segmentation")
    loader = tloader.Loader(src, 2, shuffle=False, drop_last=False)
    out = list(tloader.prefetch_to_device(loader.epoch(0), "cpu"))
    assert [tuple(b["image"].shape) for b in out] == [(2, 8, 8, 3)] * 2 + \
        [(1, 8, 8, 3)]
    assert out[0]["image"].dtype == torch.uint8
    assert out[2]["mask"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_lr_sequence_matches_jax(mode):
    rng = np.random.default_rng(0 if mode == "max" else 1)
    metrics = np.concatenate([np.linspace(0.1, 0.5, 6), np.full(8, 0.5),
                              0.5 + rng.normal(0, 1e-5, 10),
                              rng.random(20)])
    if mode == "min":
        metrics = 1.0 - metrics
    a = tschedule.ReduceLROnPlateau(mode=mode, patience=2, min_lr=1e-5)
    b = jschedule.ReduceLROnPlateau(mode=mode, patience=2, min_lr=1e-5)
    lra = lrb = 1e-3
    seq = []
    for i, m in enumerate(metrics):
        lra, lrb = a.step(float(m), lra), b.step(float(m), lrb)
        assert lra == lrb and a.state_dict() == b.state_dict(), i
        seq.append(lra)
        if i == 20:    # the state round-trips mid-sequence
            a2 = tschedule.ReduceLROnPlateau(mode=mode, patience=2,
                                             min_lr=1e-5)
            a2.load_state_dict(a.state_dict())
            a = a2
    assert len(set(seq)) >= 3 and min(seq) == 1e-5


def test_tfevents_written_by_the_port_read_by_jax(tmp_path):
    w = ttb.SummaryWriter(str(tmp_path))
    for step in range(3):
        w.add_scalar("loss", 1.0 / (step + 1), step)
        w.add_scalar("lr", 1e-4, step)
    w.close()
    got = jtb.read_scalars(w.path)
    assert [(s, t) for s, t, _ in got] == [(s, t) for s in range(3)
                                           for t in ("loss", "lr")]
    np.testing.assert_allclose([v for _, _, v in got],
                               [1.0, 1e-4, 0.5, 1e-4, 1 / 3, 1e-4],
                               rtol=1e-7)


@pytest.mark.parametrize("out_token", ["cls", "global_pool"])
def test_vit_classifier_converter_round_trip(out_token):
    """`vit_classifier_state_dict_to_params`, the inverse the driver's
    tests hand the port's weights to JAX with, undoes
    `vit_classifier_params_to_torch` (the final norm or fc_norm)."""
    port = randomized(factory.build_model(
        Task.CLASSIFICATION, Architecture.VIT_B, num_classes=6,
        out_token=out_token, device="cpu", depth=2, embed_dim=64,
        num_heads=2))
    sd = port.state_dict()
    params = conv.vit_classifier_state_dict_to_params(sd)
    assert ("fc_norm" in params["backbone"]) == (out_token == "global_pool")
    back = conv.vit_classifier_params_to_torch(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ------------------------------------------------------------- evaluators

@pytest.mark.parametrize("H,W,h,w", [(7, 7, 2, 2), (9, 6, 4, 3),
                                     (10, 10, 7, 5), (5, 8, 2, 3),
                                     (64, 64, 30, 31)])
def test_center_crop_rounds_halves_to_even(H, W, h, w):
    """torchvision's center_crop through Python's `round`: (7 - 2) / 2 =
    2.5 crops from row 2, where floor(x + 0.5) would take row 3."""
    arr = np.arange(H * W, dtype=np.float32).reshape(H, W)
    got = teval._center_crop(arr, h, w)
    np.testing.assert_array_equal(got, jeval._center_crop(arr, h, w))
    assert got.shape == (h, w)
    half_up = int(math.floor((H - h) / 2.0 + 0.5))
    if (H - h) % 4 == 1:       # (H - h) / 2 = k + 0.5 with k even
        assert got[0, 0] != arr[half_up, int(round((W - w) / 2.0))]


@pytest.mark.parametrize("hw", [(150, 100), (40, 52), (90, 31), (64, 64)])
def test_resize_matches_jax_image_resize(hw):
    """`resize_bilinear` is `jax.image.resize(..., "bilinear")`, shrinking
    too; F.interpolate without antialiasing agrees only when enlarging."""
    x = np.random.default_rng(0).normal(size=(1, S, S, 1)).astype(np.float32)
    h, w = hw
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, h, w, 1),
                                       "bilinear"))
    got = tresize.resize_bilinear(torch.from_numpy(x), h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    plain = tresize._interpolate(torch.from_numpy(x), h, w,
                                 align_corners=False).numpy()
    assert (np.abs(plain - want).max() > 0.1) == (h < S or w < S)


class NativeSource:
    """Test split with native-size targets: `kind` "seg" gives 0/1 masks,
    "depth" a 64 px depth map and its native map with invalid zeros."""

    def __init__(self, kind, sizes, seed=3):
        self.kind, self.sizes, self.seed = kind, sizes, seed

    def __len__(self):
        return len(self.sizes)

    def get(self, i):
        rng = np.random.default_rng(self.seed * 100 + i)
        img = rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
        h, w = self.sizes[i]
        if self.kind == "seg":
            yy, xx = np.mgrid[:h, :w]
            mask = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2
                    < (min(h, w) / 3) ** 2).astype(np.float32)
            return {"image": img, "mask": mask[..., None]}
        native = rng.uniform(0.05, 1.0, (h, w, 1)).astype(np.float32)
        native[rng.random((h, w, 1)) < 0.2] = 0.0
        depth = rng.uniform(0.05, 1.0, (S, S, 1)).astype(np.float32)
        return {"image": img, "depth": depth, "native_depth": native}


SIZES = [(90, 120), (40, 52), (64, 64), (31, 100)]   # above and below S

# (JAX model, port model, inverse converter) at one block a stage
MODELS = {
    "classification": (lambda: jres.ResNetClassifier(6),
                       lambda: factory.ResNetClassifier(
                           6, stage_sizes=TINY, device="cpu"),
                       conv.resnet_classifier_state_dict_to_params),
    "segmentation": (lambda: jdl.DeepLabV3Plus(1),
                     lambda: factory.DeepLabV3Plus(1, stage_sizes=TINY,
                                                   device="cpu"),
                     conv.deeplabv3plus_state_dict_to_params),
    "depth": (lambda: jres.ResNetDepthModel(),
              lambda: factory.ResNetDepthModel(stage_sizes=TINY,
                                               device="cpu"),
              conv.resnet_depth_state_dict_to_params),
}


def _configs(task):
    argv = ["--task", task, "--arch", "resnet50", "--batch-size", "4",
            "--dataset", "Kvasir"]
    return (jargs.to_train_config(parse(jargs, argv)),
            targs.to_train_config(parse(targs, argv + [
                "--device", "cpu", "--compute-dtype", "float32"])))


def _ledger(root):
    """eval_results.txt as (header without its timestamp, line keys)."""
    text = open(os.path.join(root, "eval_results.txt")).read()
    blocks = [b.splitlines() for b in text.split("\n[")[1:]]
    return [(b[0].split("] ", 1)[1], [ln.split(": ")[0] for ln in b[1:]])
            for b in blocks]


@pytest.mark.parametrize("task", list(MODELS))
def test_evaluators_match_jax(task, tmp_path, monkeypatch, capsys):
    """`evaluate_classification` over a ragged last batch,
    `evaluate_segmentation` and `evaluate_depth` one image at a time at
    native sizes above and below the 64 px input (the logits and the
    aligned depth resized as JAX resizes them, the depth center-cropped),
    with the per-instance list: the results within 1e-4 of JAX's, the
    same printed names and the same eval_results.txt header and keys."""
    monkeypatch.setattr(jres, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    monkeypatch.setattr(jdl, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    jmodel, tmodel, to_params = MODELS[task]
    port = randomized(tmodel())
    params, stats = to_params(port.state_dict())
    jcfg, tcfg = _configs(task)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jroot.mkdir()
    troot.mkdir()
    if task == "classification":
        src = tloader.SyntheticSource(10, S, task, seed=2)
        want = jeval.evaluate_classification(jcfg, jmodel(), params, stats,
                                             src, 6, str(jroot))
        jout = capsys.readouterr().out
        got = teval.evaluate_classification(tcfg, port, src, 6, str(troot))
    else:
        src = NativeSource("seg" if task == "segmentation" else "depth",
                           SIZES)
        fn = (jeval.evaluate_segmentation, teval.evaluate_segmentation) if \
            task == "segmentation" else (jeval.evaluate_depth,
                                         teval.evaluate_depth)
        want = fn[0](jcfg, jmodel(), params, stats, src, str(jroot),
                     print_list=True)
        jout = capsys.readouterr().out
        got = fn[1](tcfg, port, src, str(troot), print_list=True)
    tout = capsys.readouterr().out
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= EVAL_ATOL, (k, got[k], want[k])
    assert _printed(tout)[0] == _printed(jout)[0]
    np.testing.assert_allclose(_printed(tout)[1], _printed(jout)[1],
                               rtol=0, atol=EVAL_ATOL)
    assert _ledger(troot) == _ledger(jroot)


def _printed(out):
    """(the printed lines without their numbers, the per-instance list)."""
    lines = out.splitlines()
    listed = [float(ln.strip().rstrip(",")) for ln in lines
              if ln.startswith("    ")]
    return [ln.split(": ")[0] for ln in lines
            if not ln.startswith("    ")], listed
