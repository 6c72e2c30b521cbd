"""The port's pretraining driver (`ssl4gie_tpu_torch/ssl/pretrain.py`,
`cli/pretrain.py`) against the JAX package's, on the CPU: `PretrainConfig`'s
defaults, the CLI's checks and recipe defaults, `discover_unlabeled` and
`UnlabeledSource` byte for byte, the retained slots' names and pruning,
`--remat`, every `--arch` of both frameworks through `main` on the CPU,
resume bitwise equal to a straight run across both preemption cases (exit
code 42), and the card required unless `--device cpu`.

Sizes: the ViTs are cut to width 64, depth 1 (the conv-stem ones too), 2
heads, at 224 px; the ResNet-50 one block a stage; the MoCo heads 16 wide
with a hidden width of 32; the MAE encoder 1 block of 64, its decoder 1
block of 32; B = 4 over 8 synthetic canvases (two steps an epoch); float32
on the CPU. The narrowing patches the port's presets and config
constructors, never the code under test."""

import dataclasses
import functools
import os
import signal
import sys

import numpy as np
import pytest
import torch

from ssl4gie_tpu.cli import pretrain as jcli
from ssl4gie_tpu.core import config as jconfig
from ssl4gie_tpu.ssl import pretrain as jpre
from ssl4gie_tpu_torch.cli import pretrain as tcli
from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
from ssl4gie_tpu_torch.core.config import DataConfig, PretrainConfig
from ssl4gie_tpu_torch.core.preempt import REQUEUE_EXIT_CODE
from ssl4gie_tpu_torch.ssl import mae as tmae
from ssl4gie_tpu_torch.ssl import moco_v3 as tmoco
from ssl4gie_tpu_torch.ssl import pretrain as tpre

torch.set_num_threads(1)

CPU = ["--device", "cpu", "--compute-dtype", "float32"]
TINY_MAE = dict(patch_size=16, embed_dim=64, depth=1, num_heads=2,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)


@pytest.fixture
def narrow(monkeypatch):
    """Every preset cut to test width (see the module's docstring)."""
    for arch, preset in list(tmoco.VIT_PRESETS.items()):
        monkeypatch.setitem(tmoco.VIT_PRESETS, arch,
                            dict(preset, embed_dim=64, depth=1, num_heads=2))
    monkeypatch.setitem(tmae.MAE_SIZES, "vit_b", TINY_MAE)
    monkeypatch.setattr(tpre, "MoCo", functools.partial(
        tmoco.MoCo, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setattr(tcli, "PretrainConfig", functools.partial(
        PretrainConfig, moco_dim=16, moco_mlp_dim=32))
    monkeypatch.setattr(tcli, "DataConfig", functools.partial(
        DataConfig, synthetic_size=8))


def _argv(fw, arch, ckpt_dir, *extra):
    return ["--framework", fw, "--arch", arch, "--synthetic", "--batch-size",
            "4", "--epochs", "2", "--warmup-epochs", "1", "--ckpt-dir",
            str(ckpt_dir), *CPU, *extra]


# ------------------------------------------------------------ config, CLI

def test_pretrain_config_defaults_match_jax():
    """Every field of the JAX `PretrainConfig` with its default, in the
    nested data and runtime configs too."""
    def fields(cfg):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            out[f.name] = fields(v) if dataclasses.is_dataclass(v) else (
                v.value if hasattr(v, "value") else v)
        return out

    ours, ref = fields(PretrainConfig()), fields(jconfig.PretrainConfig())
    ours["runtime"].pop("device")            # the port's own field
    assert ours == ref
    assert PretrainConfig(batch_size=512).effective_lr() == pytest.approx(
        1.5e-4 * 2)


def _jax_cli_config(monkeypatch, argv):
    """The PretrainConfig the JAX CLI hands `run_pretraining`."""
    seen = {}
    monkeypatch.setattr(jpre, "run_pretraining",
                        lambda cfg: seen.setdefault("cfg", cfg))
    monkeypatch.setattr("ssl4gie_tpu.core.mesh.maybe_init_distributed",
                        lambda: None)
    monkeypatch.setattr(sys, "argv", ["pretrain", *argv])
    jcli.main()
    return seen["cfg"]


@pytest.mark.parametrize("argv", [
    ["--framework", "mae"],
    ["--framework", "mae", "--arch", "vit_l", "--remat", "--blr", "1e-4"],
    ["--framework", "mocov3", "--arch", "vit_b"],
    ["--framework", "mocov3", "--arch", "vit_conv_s", "--optimizer", "lars",
     "--weight-decay", "0.05", "--moco-m", "0.996", "--moco-t", "1.0"],
    ["--framework", "mocov3", "--arch", "resnet50"],
    ["--framework", "mocov3", "--arch", "resnet50", "--optimizer", "adamw",
     "--save-every", "5", "--keep-last", "3", "--epochs", "100",
     "--warmup-epochs", "10", "--batch-size", "4096", "--seed", "1"]])
def test_cli_recipe_defaults_match_jax(monkeypatch, argv):
    """The recipe defaults (MAE 1.5e-4 / 0.05; MoCo ViT AdamW 1.5e-4 / 0.1;
    MoCo RN50 LARS 0.3 / 1.5e-6) and every flag land in the same fields
    as the JAX CLI's."""
    ref = _jax_cli_config(monkeypatch, argv)
    p = tcli.build_parser()
    ours = tcli.to_pretrain_config(p, p.parse_args(argv))
    for f in ("framework", "architecture", "epochs", "warmup_epochs",
              "base_lr", "weight_decay", "batch_size", "mask_ratio",
              "norm_pix_loss", "moco_momentum", "moco_temperature",
              "optimizer", "save_every", "keep_last", "model_kwargs",
              "ckpt_dir"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a.value if hasattr(a, "value") else a) == (
            b.value if hasattr(b, "value") else b), f
    assert ours.data.synthetic == ref.data.synthetic
    assert ours.runtime.seed == ref.runtime.seed
    assert ours.runtime.device == "cuda"


@pytest.mark.parametrize("argv", [
    ["--framework", "mocov3", "--remat"],
    ["--framework", "mae", "--arch", "vit_s"],
    ["--framework", "mae", "--arch", "resnet50"],
    ["--framework", "mocov3", "--arch", "vit_h"],
    ["--framework", "byol"]])
def test_cli_errors_match_jax(monkeypatch, capsys, argv):
    """The combinations the JAX CLI refuses exit 2 in both, with the same
    message."""
    with pytest.raises(SystemExit) as ref:
        _jax_cli_config(monkeypatch, argv)
    ref_err = capsys.readouterr().err.splitlines()[-1]
    p = tcli.build_parser()
    with pytest.raises(SystemExit) as ours:
        tcli.to_pretrain_config(p, p.parse_args(argv))
    assert ours.value.code == ref.value.code == 2
    assert capsys.readouterr().err.splitlines()[-1].split(": ", 1)[1] == \
        ref_err.split(": ", 1)[1]


def test_cli_needs_the_card_unless_cpu(monkeypatch, tmp_path, narrow):
    """Without `--device cpu` and without a card the CLI raises before
    it builds anything; float32 on the card and the multi-GPU flags raise
    and name their ROADMAP item."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--framework", "mocov3", "--synthetic", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(base)
    with pytest.raises(NotImplementedError, match="queue 2 C"):
        tcli.main(base + ["--compute-dtype", "float32"])
    for flag in (["--tp", "2"], ["--fsdp"]):
        with pytest.raises(NotImplementedError, match="item 6"):
            tcli.main(base + CPU + flag)
    assert not any(f.endswith(".pt") for f in os.listdir(tmp_path))


# ------------------------------------------------------------ data, slots

def test_discover_and_unlabeled_source_match_jax(tmp_path):
    """The same sorted file list (.jpg, .jpeg and .png, recursively; other
    files ignored) and the same decoded canvases, byte for byte."""
    from PIL import Image
    rng = np.random.default_rng(0)
    for i, rel in enumerate(["a/x.jpg", "a/b/y.png", "z.jpeg", "c/w.png",
                             "c/gray.png", "notes.txt"]):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if rel.endswith(".txt"):
            path.write_text("not an image")
            continue
        shape = (40 + i, 50, 3) if "gray" not in rel else (30, 30)
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            path)
    paths = tpre.discover_unlabeled(str(tmp_path))
    assert paths == jpre.discover_unlabeled(str(tmp_path))
    assert len(paths) == 5
    ours, ref = (tpre.UnlabeledSource(paths, canvas=64),
                 jpre.UnlabeledSource(paths, canvas=64))
    for i in range(len(paths)):
        a, b = ours.get(i)["image"], ref.get(i)["image"]
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


class _DirSlot:
    """Stands in for the JAX package's orbax CheckpointManager: a slot is
    a directory, so that `_retained_save`'s pruning sees the same names."""

    def __init__(self, directory, name):
        self.path = os.path.join(directory, name)

    def save(self, tree):
        os.makedirs(self.path, exist_ok=True)

    def delete(self):
        os.rmdir(self.path)


@pytest.mark.parametrize("fw,epochs,save_every,keep_last", [
    ("mocov3", 5, None, 0), ("mocov3", 5, None, 2), ("mocov3", 7, 3, 0),
    ("mae", 45, None, 0), ("mae", 45, None, 1), ("mae", 12, 5, 2)])
def test_retained_slots_match_jax(monkeypatch, tmp_path, fw, epochs,
                                  save_every, keep_last):
    """After every epoch of a run, the retained slots are the JAX
    package's (MoCo `checkpoint_%04d` every epoch, MAE `checkpoint-%d`
    every 20 and at the last, 0-based; `save_every`, `keep_last`), as
    files `<name>.pt` holding the tree saved."""
    monkeypatch.setattr(jpre.ckpt_lib, "CheckpointManager", _DirSlot)
    kw = dict(framework=jconfig.SSLFramework(fw), epochs=epochs,
              save_every=save_every, keep_last=keep_last)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jcfg = jconfig.PretrainConfig(ckpt_dir=str(jdir), **kw)
    tcfg = PretrainConfig(ckpt_dir=str(tdir), **kw)
    for epoch in range(1, epochs + 1):
        jpre._retained_save(jcfg, {}, epoch)
        tpre._retained_save(tcfg, {"epoch": torch.tensor(epoch)}, epoch)
        assert sorted(f[:-3] for f in os.listdir(tdir)) == sorted(
            os.listdir(jdir)), epoch
    names = sorted(os.listdir(tdir))
    assert names and all(f.endswith(".pt") for f in names)
    last = ckpt_lib.CheckpointManager(str(tdir), names[-1][:-3]).restore()
    assert int(last["epoch"]) == epochs


# ------------------------------------------------------------- the model

def test_remat_gives_the_same_loss_and_gradients():
    """The MAE with `remat=True` (every block recomputed in the backward)
    gives the loss and every gradient of the one without, bitwise."""
    grads = []
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 224, 224, 3)).astype(np.float32))
    noise = torch.rand((2, 196), generator=torch.Generator().manual_seed(1))
    for remat in (False, True):
        model = tmae.MAE(remat=remat, device="cpu", **TINY_MAE)
        loss = model(x, noise)[0]
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for n, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][n]), n


# ------------------------------------------------------------ the driver

@pytest.mark.parametrize("fw,arch", [
    ("mocov3", "vit_b"), ("mocov3", "vit_s"), ("mocov3", "vit_conv_s"),
    ("mocov3", "vit_conv_b"), ("mocov3", "resnet50"), ("mae", "vit_b")])
def test_cli_runs_every_arch_on_the_cpu(tmp_path, narrow, capsys, fw, arch):
    """`main` for two epochs on the CPU: the export slot holds the
    encoder's parameters only, under the finetune models' names; the
    resume slot the full state at epoch 2 and step 4 (MoCo: the encoder,
    predictor and momentum encoder with their statistics; LARS for RN50);
    the MoCo run's retained slots 0 and 1; the logger's peak-memory lines
    absent on the CPU, and finite losses."""
    path = tcli.main(_argv(fw, arch, tmp_path) + ["--keep-last", "2"])
    assert path == str(tmp_path / f"{fw}_{arch}.pt")
    assert "pretrained encoder checkpoint" in capsys.readouterr().out
    export = ckpt_lib.CheckpointManager(str(tmp_path), f"{fw}_{arch}")
    tree = export.restore()
    full = ckpt_lib.CheckpointManager(str(tmp_path),
                                      f"{fw}_{arch}.resume").restore()
    assert tree["meta"]["epoch"] == full["meta"]["epoch"] == 2
    assert full["step"] == 4
    model = full["model"]
    if fw == "mocov3":
        enc = {k[len("encoder."):]: v for k, v in model.items()
               if k.startswith("encoder.") and "running" not in k}
        assert tree["params"].keys() == enc.keys()
        assert any(k.startswith("momentum_encoder.") for k in model)
        assert any(k.startswith("predictor.") for k in model)
        prefix = "backbone.layer1.0." if arch == "resnet50" else \
            "backbone.blocks.0."
        assert any(k.startswith(prefix) for k in tree["params"])
        lars = "count" in full["optimizer"]["param_groups"][0]
        assert lars == (arch == "resnet50")
        assert sorted(f for f in os.listdir(tmp_path)
                      if f.startswith("checkpoint")) == [
            "checkpoint_0000.pt", "checkpoint_0001.pt"]
    else:
        assert tree["params"].keys() == model.keys()


def _signal_at(monkeypatch, make, at_step):
    """Patch the full-step factory `make` of `ssl.pretrain` so that the
    step of global index `at_step` sends SIGTERM to this process."""
    real = getattr(tpre, make)

    def wrapped(*a, **kw):
        step = real(*a, **kw)

        def full_step(model, opt, img, gen, i):
            out = step(model, opt, img, gen, i)
            if i == at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return full_step

    monkeypatch.setattr(tpre, make, wrapped)


@pytest.mark.parametrize("fw,at_step,saved_epoch", [
    ("mocov3", 1, 1),     # after epoch 1's last step: save, then exit
    ("mocov3", 2, 1),     # mid-epoch 2: exit without saving
    ("mae", 2, 1)])
def test_preempted_run_resumes_bitwise(monkeypatch, tmp_path, narrow, fw,
                                       at_step, saved_epoch):
    """A run preempted by SIGTERM exits with code 42, having saved after
    the epoch it finished (and nothing mid-epoch); rerunning the same
    command resumes and ends bitwise equal to a straight run: the model's
    state (momentum parameters and statistics included), the optimizer's
    and the step."""
    straight = tmp_path / "straight"
    tcli.main(_argv(fw, "vit_b", straight))
    with monkeypatch.context() as m:
        _signal_at(m, f"make_{'moco' if fw == 'mocov3' else 'mae'}_full_step",
                   at_step)
        with pytest.raises(SystemExit) as e:
            tcli.main(_argv(fw, "vit_b", tmp_path / "run"))
    assert e.value.code == REQUEUE_EXIT_CODE == 42
    slot = ckpt_lib.CheckpointManager(str(tmp_path / "run"),
                                      f"{fw}_vit_b.resume")
    assert slot.meta()["epoch"] == saved_epoch
    tcli.main(_argv(fw, "vit_b", tmp_path / "run"))
    want = ckpt_lib.CheckpointManager(str(straight),
                                      f"{fw}_vit_b.resume").restore()
    got = slot.restore()
    assert got["step"] == want["step"] == 4

    def equal(a, b, where):
        if torch.is_tensor(a):
            assert torch.equal(a, b), where
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                equal(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                equal(x, y, f"{where}[{i}]")
        else:
            assert a == b, where

    equal(got, want, "state")
