"""The SSL finetune recipes through the port's driver on the CPU: MAE and
MoCo v3 exports written by the port's own pretraining code
(`ssl/pretrain.py:PretrainRun.save`), then `build_trainer` and `fit` for
one epoch of each recipe (the MAE finetune recipe with layer decay,
mixup/cutmix, smoothing, RandAugment, erasing, drop path and global_pool
from the MAE export; the MoCo v3 probe; the MAE probe with `head_bn`): the
load bitwise and complete, the probes' backbones unchanged; a resume that
replays bitwise with mixup on; a `cli.train` subprocess with the MAE
recipe's flags; `--pretraining ImageNet_class` from its environment file;
the detector's load; and the flags that still raise. Narrow ViTs (2
blocks of 64, 2 heads; the detector 3) at 64 px, float32, B = 8."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                           PretrainConfig, RuntimeConfig,
                                           SSLFramework)
from ssl4gie_tpu_torch.ssl import moco_v3 as tmoco
from ssl4gie_tpu_torch.ssl.lars import LARS
from ssl4gie_tpu_torch.ssl.pretrain import build_pretraining
from ssl4gie_tpu_torch.tasks import build as tbuild
from test_torch_ingest import _augreg_npz, _vit_sd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(depth=2, embed_dim=64, num_heads=2)
MAE_RECIPE = ["--layer-decay", "0.65", "--drop-path", "0.1", "--mixup",
              "0.8", "--cutmix", "1.0", "--smoothing", "0.1", "--aa",
              "rand-m9-mstd0.5-inc1", "--reprob", "0.25", "--out-token",
              "global_pool", "--pretraining", "Hyperkvasir",
              "--ss-framework", "mae"]
MOCO_PROBE = ["--probe", "--pretraining", "Hyperkvasir", "--ss-framework",
              "mocov3"]
MAE_PROBE = ["--probe", "--pretraining", "Hyperkvasir", "--ss-framework",
             "mae"]


def _export(framework, tmp, monkeypatch):
    """A narrow export of the port's pretraining code, as its driver
    writes it at the end of an epoch."""
    monkeypatch.setitem(tmoco.VIT_PRESETS, "vit_b",
                        dict(VIT, stem="patch"))
    cfg = PretrainConfig(
        framework=framework, architecture=Architecture.VIT_B, img_size=64,
        batch_size=4, moco_dim=16, moco_mlp_dim=32,
        model_kwargs=(dict(VIT, decoder_embed_dim=32, decoder_depth=1,
                           decoder_num_heads=2)
                      if framework == SSLFramework.MAE else {}),
        data=DataConfig(synthetic=True, synthetic_size=8, num_workers=1),
        runtime=RuntimeConfig(device="cpu", compute_dtype="float32"),
        ckpt_dir=str(tmp))
    build_pretraining(cfg).save(1)
    return os.path.join(str(tmp), f"{framework.value}_vit_b.pt")


@pytest.fixture
def exports(tmp_path, monkeypatch):
    return {fw: _export(SSLFramework(fw), tmp_path / "pre", monkeypatch)
            for fw in ("mae", "mocov3")}


def port_config(tmp, *extra, n=16):
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        ["--task", "classification", "--arch", "vit_b", "--synthetic",
         "--batch-size", "8", "--compute-dtype", "float32", "--device",
         "cpu", "--ckpt-dir", os.path.join(str(tmp), "ckpt"), *extra]))
    cfg.data.synthetic_size, cfg.data.img_size = n, 64
    cfg.data.num_workers = 2
    cfg.runtime.log_every = 1
    return cfg


def _export_params(path):
    """The export's backbone tensors under the backbone's names."""
    params = torch.load(path, weights_only=True)["params"]
    if any(k.startswith("backbone.") for k in params):
        params = {k[len("backbone."):]: v for k, v in params.items()
                  if k.startswith("backbone.")}
    return params


RECIPES = {"mae_finetune": ("mae", MAE_RECIPE, {"fc_norm.weight",
                                                "fc_norm.bias", "pos_embed"}),
           "moco_probe": ("mocov3", MOCO_PROBE, set()),
           "mae_probe": ("mae", MAE_PROBE, {"pos_embed"})}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_builds_loads_and_fits(recipe, exports, tmp_path):
    """The load: every backbone tensor that the export holds equals it
    bitwise before the first step, and only the expected ones (MAE's fixed
    position embedding is a buffer, and global_pool's fc_norm is fresh)
    are not loaded. One epoch: finite losses; the MAE recipe's optimizer
    has one group per layer scale; the probes' backbones bitwise
    unchanged, only `lin_head` moved (and the MAE probe's `head_bn`
    statistics)."""
    fw, flags, unloaded = RECIPES[recipe]
    path = exports[fw]
    trainer = tbuild.build_trainer(
        port_config(tmp_path, *flags, "--epochs", "1", "--checkpoint", path),
        **VIT)
    model = trainer.model
    export = _export_params(path)
    bb = model.backbone.state_dict()
    assert set(bb) - set(export) == unloaded
    for k in set(bb) & set(export):
        assert torch.equal(bb[k], export[k]), k
    before = {k: v.clone() for k, v in model.state_dict().items()}
    best = trainer.fit()
    assert np.isfinite(best)
    after = model.state_dict()
    ledger = [ln for ln in open(trainer.logger.jsonl_path)
              if '"loss"' in ln]
    assert len(ledger) == 2
    if recipe == "mae_finetune":
        scales = sorted(g["lr_scale"] for g in trainer.optimizer.param_groups)
        assert scales == pytest.approx([0.65 ** 3, 0.65 ** 2, 0.65, 1.0])
        assert trainer.task.mixup_fn is not None
        assert not torch.equal(after["backbone.blocks.0.attn.qkv.weight"],
                               before["backbone.blocks.0.attn.qkv.weight"])
        return
    for k, v in after.items():
        moved = not torch.equal(v, before[k])
        assert moved == (k.startswith("lin_head.")
                         or k.startswith("head_bn.")), k
    assert isinstance(trainer.optimizer, LARS if fw == "mae"
                      else torch.optim.SGD)
    assert hasattr(model, "head_bn") and (model.head_bn is not None) == (
        fw == "mae")


def test_mixup_resume_replays_bitwise(exports, tmp_path):
    """The MAE recipe (mixup, cutmix, RandAugment, erasing, drop path):
    one epoch, then a build with --epochs 2 that resumes from the slot and
    runs the second, equal bitwise to two epochs straight (weights and
    AdamW state); every draw is a function of (seed, epoch)."""
    flags = MAE_RECIPE + ["--checkpoint", exports["mae"]]
    straight = tbuild.build_trainer(
        port_config(tmp_path / "a", *flags, "--epochs", "2"), **VIT)
    straight.fit()
    tbuild.build_trainer(port_config(tmp_path / "b", *flags, "--epochs",
                                     "1"), **VIT).fit()
    resumed = tbuild.build_trainer(
        port_config(tmp_path / "b", *flags, "--epochs", "2"), **VIT)
    resumed.fit()
    assert resumed.start_epoch == 2
    for k, v in straight.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    a, b = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)


_CHILD = """
import functools, runpy, sys
from ssl4gie_tpu_torch.cli import args
from ssl4gie_tpu_torch.models import factory
full = args.to_train_config
def small(a):
    cfg = full(a)
    cfg.data.synthetic_size, cfg.data.img_size = 16, 64
    cfg.data.num_workers = 2
    return cfg
args.to_train_config = small
factory.build_model = functools.partial(factory.build_model, depth=2,
                                        embed_dim=64, num_heads=2)
sys.argv = {argv!r}
runpy.run_module("ssl4gie_tpu_torch.cli.train", run_name="__main__")
"""


def test_cli_train_mae_recipe_subprocess(exports, tmp_path):
    """`python -m ssl4gie_tpu_torch.cli.train` with the MAE recipe's flags
    and --checkpoint on the CPU (the config and the model cut in the
    child): it loads, trains an epoch and saves the best-val slot."""
    argv = ["cli.train", "--task", "classification", "--arch", "vit_b",
            "--synthetic", "--batch-size", "8", "--compute-dtype",
            "float32", "--device", "cpu", "--epochs", "1", "--ckpt-dir",
            str(tmp_path / "ckpt"), "--checkpoint", exports["mae"],
            *MAE_RECIPE]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _CHILD.format(argv=argv)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "Loaded 27 converted tensors" in r.stdout
    assert "best val performance" in r.stdout
    assert os.path.isfile(tmp_path / "ckpt" /
                          "vit_b-Hyperkvasir_mae_init-frozen_False-dataset_.pt")


def test_imagenet_class_and_detector_loads(tmp_path, monkeypatch):
    """--pretraining ImageNet_class loads the .npz of its environment
    variable (and raises without it); a detection build with --checkpoint
    puts the encoder into the ViTDet backbone (no cls token there)."""
    npz = _augreg_npz(_vit_sd(seed=3), tmp_path / "augreg.npz")
    monkeypatch.delenv("SSL4GIE_IMAGENET_VIT_NPZ", raising=False)
    cfg = port_config(tmp_path, "--pretraining", "ImageNet_class")
    with pytest.raises(FileNotFoundError, match="SSL4GIE_IMAGENET_VIT_NPZ"):
        tbuild.build_trainer(cfg, **VIT)
    monkeypatch.setenv("SSL4GIE_IMAGENET_VIT_NPZ", npz)
    trainer = tbuild.build_trainer(cfg, **VIT)
    np.testing.assert_array_equal(
        trainer.model.backbone.cls_token.detach().numpy(),
        np.load(npz)["cls"])

    det = dict(depth=3, embed_dim=64, num_heads=2)
    sd = _vit_sd(seed=4, depth=3)
    path = tmp_path / "timm3.pth"
    torch.save(sd, path)
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    dcfg = targs.to_train_config(p.parse_args(
        ["--task", "detection", "--arch", "vit_b", "--synthetic",
         "--batch-size", "2", "--compute-dtype", "float32", "--device",
         "cpu", "--ckpt-dir", str(tmp_path / "det"), "--checkpoint",
         str(path)]))
    dcfg.data.synthetic_size = 4
    trainer = tbuild.build_trainer(dcfg, **det)
    bb = trainer.model.backbone.state_dict()
    assert "cls_token" not in bb
    for k, v in bb.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("flags,match", [
    (["--tp", "2"], "does not divide"), (["--fsdp"], None),
    (["--device", "cuda"], "queue 2 C")])
def test_flags_that_still_raise(tmp_path, flags, match):
    """Float32 on the card (ROADMAP queue 2 C, the case's label: it raised
    until the float32 kernels) now gives its config with the recipe's
    flags. Tensor parallelism and FSDP are ported: with the recipe's flags
    they give their config fields, and `--tp 2` in one process fails in
    `make_tp_mesh` (two ranks would divide it)."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    argv = ["--task", "classification", "--synthetic", "--compute-dtype",
            "float32", *MAE_RECIPE, *flags]
    if "--device" not in flags:
        argv += ["--device", "cpu"]
    if "--device" in flags:
        cfg = targs.to_train_config(p.parse_args(argv))
        assert (cfg.runtime.device, cfg.runtime.compute_dtype) == (
            "cuda", "float32")
        assert cfg.optim.layer_decay == 0.65 and cfg.optim.mixup == 0.8
        return
    cfg = targs.to_train_config(p.parse_args(argv))
    assert (cfg.runtime.tensor_parallel, cfg.runtime.fsdp) == (
        (2, False) if "--tp" in flags else (1, True))
    assert cfg.optim.layer_decay == 0.65 and cfg.optim.mixup == 0.8
    if match is not None:
        with pytest.raises(ValueError, match=match):
            tbuild.build_trainer(cfg)
