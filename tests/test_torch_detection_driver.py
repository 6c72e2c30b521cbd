"""The port's detection driver against the JAX package's, on the CPU:
`DetectionTrainer`'s epoch bookkeeping against JAX's with `train_epoch`
and `evaluate` scripted alike on both sides (plateau, best-val saves,
ledger keys, the `.preempt` slot and resume), one real epoch bitwise equal
to `make_detection_full_step` called by hand (also with two microbatches),
resume bitwise equal to a straight run, a mid-epoch preemption, the
detection branches of `build_trainer` against JAX's
`_build_detection_trainer` choices (read without its model init), and one
`cli.train` -> `cli.evaluate` -> `cli.predict` subprocess cycle.

Sizes: the ViT detector 3 blocks of 64 (block 2 global), 2 heads, on the
synthetic 256 px canvas with the reduced proposal counts; B = 4 over
synthetic splits of 4-8 images; float32 on the CPU."""

import argparse
import functools
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.cli import args as jargs
from ssl4gie_tpu.core import checkpoint as jckpt
from ssl4gie_tpu.core.logger import MetricsLogger as JaxLogger
from ssl4gie_tpu.core.mesh import make_mesh
from ssl4gie_tpu.core.schedule import ReduceLROnPlateau as JaxPlateau
from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.models import faster_rcnn as jfr
from ssl4gie_tpu.tasks import build as jbuild
from ssl4gie_tpu.tasks import detection as jdet
from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.core.preempt import Preempted
from ssl4gie_tpu_torch.core.trainer import epoch_seed
from ssl4gie_tpu_torch.tasks import build as tbuild
from ssl4gie_tpu_torch.tasks import detection as tdet

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
DET = dict(depth=3, embed_dim=64, num_heads=2)
# scripted val / test mAP per epoch: a best at 1, two bad epochs (the
# plateau at patience 1 cuts the LR after epoch 3), a best at 4
VAL = {1: 0.2, 2: 0.1, 3: 0.15, 4: 0.3, 5: 0.05}
TEST = {1: 0.21, 2: 0.11, 3: 0.12, 4: 0.31, 5: 0.07}


def _argv(arch, tmp, *extra, synthetic=True):
    return ["--task", "detection", "--arch", arch, "--batch-size", str(B),
            "--compute-dtype", "float32", "--ckpt-dir",
            os.path.join(str(tmp), "ckpt"),
            *(["--synthetic"] if synthetic else []), *extra]


def port_config(arch, tmp, *extra, n=8, synthetic=True):
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        _argv(arch, tmp, *extra, synthetic=synthetic) + ["--device", "cpu"]))
    cfg.data.synthetic_size = n
    cfg.data.num_workers = 2
    cfg.runtime.log_every = 1
    return cfg


def jax_config(arch, tmp, *extra, n=8, synthetic=True):
    p = argparse.ArgumentParser()
    jargs.add_common(p)
    jargs.add_train(p)
    cfg = jargs.to_train_config(p.parse_args(
        _argv(arch, tmp, *extra, synthetic=synthetic)))
    cfg.data.synthetic_size = n
    cfg.data.num_workers = 2
    cfg.runtime.log_every = 1
    cfg.log_dir = os.path.join(str(tmp), "jax_logs")
    cfg.ckpt_dir = os.path.join(str(tmp), "jax_ckpt")
    return cfg


def build(tmp, *extra, n=8):
    return tbuild.build_trainer(port_config("vit_b", tmp, *extra, n=n),
                                **DET)


def _ledger(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            trainer.optimizer.state_dict())


def _assert_bitwise(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    else:
        assert a == b


# ------------------------------------------------------------ bookkeeping

def jax_trainer(cfg):
    """JAX's DetectionTrainer with a one-device mesh and a stand-in
    parameter tree: its `train_epoch` and `evaluate` are scripted, so no
    model runs."""
    o = cfg.optim
    plateau = (JaxPlateau(mode="max", factor=o.plateau_factor,
                          patience=o.plateau_patience, min_lr=o.min_lr)
               if o.use_plateau_scheduler else None)
    mk = lambda seed: jdet.SyntheticDetectionSource(8, 256, seed)
    return jdet.DetectionTrainer(
        cfg, make_mesh(), None, {"w": jnp.zeros((3,), jnp.float32)}, {},
        jax_make_adamw(o.learning_rate), mk(0), mk(1), mk(2),
        JaxLogger(cfg.log_dir, cfg.run_name(), to_stdout=False),
        jckpt.CheckpointManager(cfg.ckpt_dir, cfg.run_name()), plateau)


def script(trainer, signal_at=None):
    """Replace the trainer's epoch and evaluation by the scripted ones: no
    training, the VAL/TEST mAPs logged as the real `evaluate` logs them;
    SIGTERM during the val pass of epoch `signal_at`."""
    def train_epoch(epoch):
        return None

    def evaluate(source, epoch, split):
        if split == "val" and epoch == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        res = (VAL if split == "val" else TEST)[epoch]
        trainer.logger.log({"epoch": epoch, f"{split}_map": res,
                            f"{split}_map50": res})
        return res

    trainer.train_epoch, trainer.evaluate = train_epoch, evaluate
    return trainer


def _events(path):
    lines = _ledger(path)
    return ([sorted(p) for p in lines],
            [p["lr_reduced_to"] for p in lines if "lr_reduced_to" in p],
            [p["epoch"] for p in lines if "new_best_val_map" in p])


def test_bookkeeping_matches_jax_detection_trainer(tmp_path):
    """Five scripted epochs, plateau patience 1: the same ledger key sets,
    LR reductions and best-val epochs; then a run preempted during epoch
    2's val pass saves the `.preempt` slot at epoch 2 on both sides, and a
    relaunch prefers it (start_epoch 3) on both, trains past it and deletes
    it."""
    extra = ("--epochs", "5", "--lrs")
    port = script(build(tmp_path / "p", *extra))
    port.plateau.patience = 1
    jcfg = jax_config("vit_b", tmp_path / "j", *extra)
    jcfg.optim.plateau_patience = 1
    jt = script(jax_trainer(jcfg))
    assert port.fit() == jt.fit() == VAL[4]
    got, want = _events(port.logger.jsonl_path), _events(jt.logger.jsonl_path)
    assert got == want
    assert want[1] == [1e-4 * 0.5] and want[2] == [1, 4]

    extra = ("--epochs", "4", "--lrs")
    runs = {}
    for side, mk in (("port", lambda: build(tmp_path / "p2", *extra)),
                     ("jax", lambda: jax_trainer(jax_config(
                         "vit_b", tmp_path / "j2", *extra)))):
        first = script(mk(), signal_at=2)
        with pytest.raises(Exception) as e:
            first.fit()
        assert type(e.value).__name__ == "Preempted"
        assert first.preempt_ckpt.exists()
        second = script(mk())
        second.maybe_resume()
        third = script(mk())
        best = third.fit()
        runs[side] = (second.start_epoch, second._preempt_slot_epoch,
                      second.best_val, best, third.preempt_ckpt.exists(),
                      sorted(map(sorted, _ledger(first.logger.jsonl_path))))
    assert runs["port"] == runs["jax"]
    assert runs["port"][:2] == (3, 2)
    assert not runs["port"][4]


# ------------------------------------------------------------ real epochs

@pytest.mark.parametrize("accum", [1, 2])
def test_epoch_is_the_full_step_by_hand(tmp_path, accum):
    """`train_epoch(1)` bitwise equal to the Loader's epoch-1 batches fed
    to `make_detection_full_step(accum)` by hand with the epoch's
    generator, from the same initial weights; the ledger's step lines."""
    extra = ("--accum-iter", str(accum))
    t = build(tmp_path / "a", *extra)
    hand = build(tmp_path / "b", *extra)
    _assert_bitwise(_state(t)[0], _state(hand)[0])
    t.train_epoch(1)
    gen = torch.Generator().manual_seed(epoch_seed(42, 1))
    step = tdet.make_detection_full_step(accum)
    for batch in hand.train_loader.epoch(1):
        step(hand.model, hand.optimizer,
             {k: torch.from_numpy(v) for k, v in batch.items()}, gen)
    _assert_bitwise(_state(t), _state(hand))
    lines = _ledger(t.logger.jsonl_path)
    assert [sorted(p) for p in lines] == [
        ["epoch", "images_per_sec", "loss", "step", "step_time_ms",
         "wall_s"]] * 2
    assert all(np.isfinite(p["loss"]) for p in lines)


def test_resume_is_bitwise_the_straight_run(tmp_path):
    """One epoch, then a fresh build that resumes and runs the second:
    weights, AdamW state and the best val mAP bitwise a straight two-epoch
    run's; `evaluate` logs the JAX trainer's keys."""
    first = build(tmp_path / "a", "--epochs", "1", "--lrs", n=4)
    first.fit()
    resumed = build(tmp_path / "a", "--epochs", "2", "--lrs", n=4)
    resumed.fit()
    assert resumed.start_epoch == 2
    straight = build(tmp_path / "b", "--epochs", "2", "--lrs", n=4)
    straight.fit()
    _assert_bitwise(_state(resumed), _state(straight))
    assert resumed.best_val == straight.best_val
    keys = set().union(*_ledger(straight.logger.jsonl_path))
    assert {"val_map", "val_map50", "test_map", "test_map50",
            "new_best_val_map", "test_map_at_best"} <= keys


def test_mid_epoch_preempt_saves_boundary_state(tmp_path):
    """A signal in the first step of epoch 1 saves the epoch-0 boundary:
    the initial weights and an untouched optimizer."""
    t = build(tmp_path, "--epochs", "2")
    orig = t.full_step
    calls = {"n": 0}

    def step_and_preempt(*args):
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*args)

    init = _state(t)
    t.full_step = step_and_preempt
    with pytest.raises(Preempted):
        t.fit()
    assert calls["n"] == 1
    saved = t.preempt_ckpt.restore()
    assert saved["meta"]["epoch"] == 0
    _assert_bitwise(saved["model"], init[0])
    _assert_bitwise(saved["optimizer"], init[1])


# ------------------------------------------------------------ build

class _Stop(Exception):
    pass


def _kvasir(root, n=10):
    """A Kvasir detection layout: `images/*.jpg` and `bounding-boxes.json`."""
    from PIL import Image
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    targets = {}
    for i in range(n):
        Image.fromarray(np.full((40, 50, 3), i * 20, np.uint8)).save(
            os.path.join(root, "images", f"f{i:02d}.jpg"))
        targets[f"f{i:02d}"] = {"bbox": [{"xmin": 1, "ymin": 2, "xmax": 20,
                                          "ymax": 30}]}
    with open(os.path.join(root, "bounding-boxes.json"), "w") as f:
        json.dump(targets, f)
    return root


def _jax_choices(cfg, monkeypatch):
    """What JAX's `_build_detection_trainer` builds, up to its model init:
    the three sources' arguments and the FasterRCNN it configures."""
    made = {"sources": []}

    def source(kind):
        def record(*args, **kwargs):
            made["sources"].append((kind, args, kwargs))
        return record

    def model(**kwargs):
        made["model"] = real(**kwargs)   # a flax dataclass: no init runs
        raise _Stop

    real = jfr.FasterRCNN
    monkeypatch.setattr(jdet, "DetectionSource", source("files"))
    monkeypatch.setattr(jdet, "SyntheticDetectionSource", source("synthetic"))
    monkeypatch.setattr(jfr, "FasterRCNN", model)
    with pytest.raises(_Stop):
        jbuild._build_detection_trainer(cfg, make_mesh())
    return made


CASES = [("vit_b", True), ("resnet50", True), ("vit_b", False),
         ("resnet50", False)]


@pytest.mark.parametrize("arch,synthetic", CASES)
def test_build_matches_jax_choices(arch, synthetic, tmp_path, monkeypatch):
    """Sources (paths, split order, canvas, placement or seeds), the
    detector's canvas and proposal counts, for both arches, from files and
    `--synthetic`."""
    root = _kvasir(str(tmp_path / "Kvasir"))
    extra = () if synthetic else ("--data-root", root, "--dataset", "Kvasir")
    jcfg = jax_config(arch, tmp_path, *extra, synthetic=synthetic)
    made = _jax_choices(jcfg, monkeypatch)
    cfg = port_config(arch, tmp_path, *extra, synthetic=synthetic)
    t = tbuild.build_trainer(cfg, **(DET if arch == "vit_b" else {}))
    srcs = [t.train_loader.source, t.val_source, t.test_source]
    for (kind, args, kwargs), src in zip(made["sources"], srcs):
        if kind == "synthetic":
            assert isinstance(src, tdet.SyntheticDetectionSource)
            assert (src.n, src.canvas, src.seed) == args
        else:
            assert isinstance(src, tdet.DetectionSource)
            assert src.paths == args[0] and src.targets == args[1]
            assert src.canvas == args[2]
            assert src.resize == kwargs["resize"]
    assert len(made["sources"]) == 3
    jm, m = made["model"], t.model
    assert m.image_size == jm.image_size
    assert m.arch == jm.arch == arch
    assert m.rpn_pre_nms_top_n == (jm.rpn_pre_nms_top_n_train,
                                   jm.rpn_pre_nms_top_n_test)
    assert m.rpn_post_nms_top_n == (jm.rpn_post_nms_top_n_train,
                                    jm.rpn_post_nms_top_n_test)
    assert m.box_batch_size_per_image == jm.box_batch_size_per_image
    assert m.detections_per_img == jm.detections_per_img
    assert jm.num_classes == 2 and jm.pos_embed_type == "learned"
    assert t.plateau is None and t.epochs == cfg.epochs


# ------------------------------------------------------------ CLIs

# the subprocess narrows the detector and the synthetic splits before the
# CLI module runs
_SMALL = """
import functools, runpy, sys
from ssl4gie_tpu_torch.cli import args
from ssl4gie_tpu_torch.models import faster_rcnn
faster_rcnn.FasterRCNN = functools.partial(faster_rcnn.FasterRCNN,
                                           **{det!r})
full = args.to_train_config
def small(a):
    cfg = full(a)
    cfg.data.synthetic_size, cfg.data.num_workers = 4, 2
    return cfg
args.to_train_config = small
sys.argv = {argv!r}
runpy.run_module({module!r}, run_name="__main__")
"""


def _run_cli(module, argv, cwd):
    code = _SMALL.format(argv=[module] + argv, module=module, det=DET)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return r.stdout


def test_cli_train_evaluate_predict_subprocess(tmp_path):
    """`cli.train --task detection --synthetic --device cpu` for one epoch,
    then `cli.evaluate` (the mAP lines and the ledger) and `cli.predict`
    (two box overlays) on its best-val slot."""
    common = ["--task", "detection", "--arch", "vit_b", "--synthetic",
              "--batch-size", "4", "--compute-dtype", "float32", "--device",
              "cpu", "--ckpt-dir", os.path.join(str(tmp_path), "ckpt")]
    out = _run_cli("ssl4gie_tpu_torch.cli.train", common + ["--epochs", "1"],
                   REPO)
    assert "best val performance" in out
    assert os.path.isfile(os.path.join(
        str(tmp_path), "ckpt", "vit_b-random_init-frozen_False-dataset_.pt"))
    out = _run_cli("ssl4gie_tpu_torch.cli.evaluate",
                   common + ["--results-root", str(tmp_path)], REPO)
    for key in ("Detection results for vit_b", "mAP:", "mAP@50:", "mAP@75:"):
        assert key in out
    assert os.path.exists(os.path.join(str(tmp_path), "eval_results.txt"))
    pred = os.path.join(str(tmp_path), "pred")
    out = _run_cli("ssl4gie_tpu_torch.cli.predict",
                   common + ["--idx", "0,1", "--out-dir", pred], REPO)
    assert "wrote 2 files" in out
    assert sorted(os.listdir(pred)) == ["det_0.png", "det_1.png"]
