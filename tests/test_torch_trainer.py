"""The port's finetune driver against the JAX package's, on the CPU, part 2:
`Trainer.evaluate` against the JAX Trainer's on the same weights and the
same synthetic val split (ragged tail included), `fit`'s ledger against the
JAX Trainer's, resume bitwise equal to a straight run, `--frozen`, the
plateau in every param group, preemption (as `tests/test_preempt.py` holds
the JAX Trainer), the CLIs (a train -> evaluate subprocess cycle, exit 42,
no card), and train -> resume -> evaluate for every task and architecture.

Sizes: the ViTs are narrow (2 blocks of 64, 2 heads; the dense ones 4
blocks with narrow DPT widths) at 224 px, the size the port's position
embedding takes; the ResNet-50s one block a stage (`TINY`) at 64 px; B = 8
over synthetic splits of 12-20 images; float32 on the CPU."""

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
from ssl4gie_tpu.core.train_state import TrainState
from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.core.trainer import Trainer as JaxTrainer
from ssl4gie_tpu.data.augment import eval_batch as jeval_batch
from ssl4gie_tpu.data import loader as jloader
from ssl4gie_tpu.models import deeplabv3plus as jdl
from ssl4gie_tpu.models import resnet as jres
from ssl4gie_tpu.models.vit import ViTClassifier as JaxViTClassifier
from ssl4gie_tpu.tasks import build as jbuild
from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.cli import evaluate as tcli_eval
from ssl4gie_tpu_torch.cli import train as tcli_train
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.core import trainer as ttrainer
from ssl4gie_tpu_torch.core.config import Architecture, Task
from ssl4gie_tpu_torch.core.logger import peak_memory_mb
from ssl4gie_tpu_torch.core.preempt import REQUEUE_EXIT_CODE, Preempted
from ssl4gie_tpu_torch.core.train_state import freeze_body, make_adamw
from ssl4gie_tpu_torch.metrics.classification import mean_f1
from ssl4gie_tpu_torch.models.factory import build_model
from ssl4gie_tpu_torch.tasks import build as tbuild
from ssl4gie_tpu_torch.tasks import evaluate as teval
from test_torch_resnet import TINY, randomized
from test_torch_segmentation import NARROW as VIT_DENSE
from test_torch_segmentation import JaxDense

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
VIT = dict(depth=2, embed_dim=64, num_heads=2)
WIDTHS = {("classification", "vit_b"): VIT,
          ("segmentation", "vit_b"): VIT_DENSE, ("depth", "vit_b"): VIT_DENSE,
          ("classification", "resnet50"): dict(stage_sizes=TINY),
          ("segmentation", "resnet50"): dict(stage_sizes=TINY),
          ("depth", "resnet50"): dict(stage_sizes=TINY)}


def _argv(task, arch, tmp, *extra):
    return ["--task", task, "--arch", arch, "--synthetic", "--batch-size",
            str(B), "--compute-dtype", "float32", "--ckpt-dir",
            os.path.join(str(tmp), "ckpt"), *extra]


def port_config(task, arch, tmp, *extra, n=16):
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        _argv(task, arch, tmp, *extra) + ["--device", "cpu"]))
    cfg.data.synthetic_size = n
    cfg.data.img_size = 224 if arch == "vit_b" else 64
    cfg.data.num_workers = 2
    cfg.runtime.log_every = 1
    return cfg


def jax_config(task, arch, tmp, *extra, n=16):
    p = argparse.ArgumentParser()
    jargs.add_common(p)
    jargs.add_train(p)
    cfg = jargs.to_train_config(p.parse_args(_argv(task, arch, tmp, *extra)))
    cfg.data.synthetic_size = n
    cfg.data.img_size = 224 if arch == "vit_b" else 64
    cfg.data.num_workers = 2
    cfg.runtime.log_every = 1
    cfg.log_dir = os.path.join(str(tmp), "jax_logs")
    cfg.ckpt_dir = os.path.join(str(tmp), "jax_ckpt")
    return cfg


def build(task, arch, tmp, *extra, n=16):
    return tbuild.build_trainer(port_config(task, arch, tmp, *extra, n=n),
                                **WIDTHS[task, arch])


def jax_trainer(cfg, model, params, stats):
    """The JAX package's Trainer on `model` (build_trainer's wiring, which
    builds only full-width models)."""
    train_src, val_src, test_src, extras = jbuild._make_sources(cfg)
    td, finalize = jbuild.make_task_definition(cfg, extras)
    o = cfg.optim
    state = TrainState.create(
        model.apply, jax.tree_util.tree_map(jnp.array, params),
        jax_make_adamw(o.learning_rate, o.b1, o.b2, o.eps,
                       o.adamw_weight_decay), stats)
    mk = lambda src, train: jloader.Loader(src, B, shuffle=train,
                                           drop_last=train, seed=42,
                                           num_threads=2)
    plateau = (JaxPlateau(mode=td.select_mode, factor=o.plateau_factor,
                          patience=o.plateau_patience, min_lr=o.min_lr)
               if o.use_plateau_scheduler else None)
    return JaxTrainer(task=td, state=state, mesh=make_mesh(),
                      train_loader=mk(train_src, True),
                      val_loader=mk(val_src, False),
                      test_loader=mk(test_src, False),
                      logger=JaxLogger(cfg.log_dir, cfg.run_name(),
                                       to_stdout=False),
                      ckpt=jckpt.CheckpointManager(cfg.ckpt_dir,
                                                   cfg.run_name()),
                      epochs=cfg.epochs, seed=42, plateau=plateau,
                      eval_finalize=finalize, log_every=1)


def vit_classifier_weights(port):
    """The narrow JAX ViT classifier and the port's weights (its init with
    random biases) as its params, by the inverse converter."""
    randomized(port.model)
    return (JaxViTClassifier(num_classes=6, dtype=jnp.float32, **VIT),
            conv.vit_classifier_state_dict_to_params(port.model.state_dict()))


def _state(trainer):
    """The model's and the optimizer's state on the host."""
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


def _ledger(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


# ------------------------------------------------------------ evaluate

def _capture(finalize, into):
    def wrapped(preds, targets):
        into.append(np.asarray(preds))
        return finalize(preds, targets)
    return wrapped


def test_evaluate_classification_matches_jax_trainer(tmp_path):
    """Predictions equal wherever JAX's two largest logits differ by more
    than 1e-4, and meanF1 equal on those, over a val split of 20 (batches
    8, 8 and a ragged 4); the Trainer's meanF1 within float32 rounding."""
    port = build("classification", "vit_b", tmp_path, n=20)
    jmodel, params = vit_classifier_weights(port)
    jt = jax_trainer(jax_config("classification", "vit_b", tmp_path, n=20),
                     jmodel, params, {})
    tp, jp = [], []
    port.eval_finalize = _capture(port.eval_finalize, tp)
    jt.eval_finalize = _capture(jt.eval_finalize, jp)
    got = port.evaluate(port.val_loader, 1, "val")
    want = jt.evaluate(jt.val_loader, 1, "val")
    assert port.model.training
    imgs = np.stack([jt.val_loader.source.get(i)["image"]
                     for i in range(20)])
    logits = np.asarray(jmodel.apply({"params": params},
                                     jeval_batch(jnp.asarray(imgs))))
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.sum() >= 18 and len(tp[0]) == len(jp[0]) == 20
    np.testing.assert_array_equal(tp[0][clear], jp[0][clear])
    labels = np.array([jt.val_loader.source.get(i)["label"]
                       for i in range(20)])
    f1 = lambda p: float(mean_f1(torch.from_numpy(p[clear]),
                                 torch.from_numpy(labels[clear]), 6))
    assert f1(tp[0]) == f1(jp[0])
    if clear.all():     # the same predictions; meanF1's float32 mean
        np.testing.assert_allclose(got, want, rtol=1e-6)   # in another order


def _rn50_seg(tmp_path):
    port = build("segmentation", "resnet50", tmp_path, n=20)
    randomized(port.model)
    params, stats = conv.deeplabv3plus_state_dict_to_params(
        port.model.state_dict())
    return port, jdl.DeepLabV3Plus(1), params, stats


def _vit_depth(tmp_path):
    port = build("depth", "vit_b", tmp_path, n=20)
    randomized(port.model)
    params, stats = conv.vit_dense_state_dict_to_params(
        port.model.state_dict())
    return port, JaxDense("depth"), params, stats


@pytest.mark.parametrize("case", ["rn50_seg", "vit_depth"])
def test_evaluate_dense_matches_jax_trainer(case, tmp_path, monkeypatch):
    """Segmentation Dice (DeepLabV3+) and depth SSI (ViT + DPT) over val
    splits of 20 (a ragged last batch of 4) within 1e-5 relative of the JAX
    Trainer's, each batch weighing the same. The model is evaluated in
    eval mode and left in train mode: BatchNorm's running statistics do not
    move (in train mode they would, and the numbers would differ)."""
    monkeypatch.setattr(jdl, "ResNet50",
                        functools.partial(jres.ResNet50, stage_sizes=TINY))
    port, jmodel, params, stats = (_rn50_seg if case == "rn50_seg"
                                   else _vit_depth)(tmp_path)
    task, arch = (("segmentation", "resnet50") if case == "rn50_seg"
                  else ("depth", "vit_b"))
    jt = jax_trainer(jax_config(task, arch, tmp_path, n=20), jmodel, params,
                     stats)
    before = _state(port)[0]
    got = port.evaluate(port.val_loader, 1, "val")
    want = jt.evaluate(jt.val_loader, 1, "val")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port.model.training
    _assert_bitwise(port.model.state_dict(), before)
    assert 0 < got < 1


# ------------------------------------------------------------ fit

def test_fit_writes_the_jax_trainers_ledger_keys(tmp_path):
    """Two epochs of the same config (learning rate 0 and plateau patience
    0, so that both runs take the same selection and LR events: a new best
    in epoch 1, the plateau's reduction in epoch 2) write the same sequence
    of ledger key sets; on the CPU neither writes max_mem_mb."""
    extra = ("--epochs", "2", "--lr", "0", "--lrs")
    cfg = port_config("classification", "vit_b", tmp_path, *extra)
    cfg.optim.plateau_patience = 0
    port = tbuild.build_trainer(cfg, **VIT)
    jmodel, params = vit_classifier_weights(port)
    port.fit()
    jcfg = jax_config("classification", "vit_b", tmp_path, *extra)
    jcfg.optim.plateau_patience = 0
    jt = jax_trainer(jcfg, jmodel, params, {})
    jt.fit()
    got = [sorted(p) for p in _ledger(port.logger.jsonl_path)]
    want = [sorted(p) for p in _ledger(jt.logger.jsonl_path)]
    assert got == want
    assert sum("lr_reduced_to" in p for p in got) == 1
    assert sum("new_best_val" in p for p in got) == 1
    assert not any("max_mem_mb" in p for p in got)
    assert peak_memory_mb("cpu") is None


def test_resume_is_bitwise_the_straight_run(tmp_path):
    """One epoch, then a fresh build_trainer that resumes from the best-val
    slot and runs the second: parameters, BatchNorm buffers, the optimizer's
    moments and step, the LR and the plateau's state end bitwise equal to a
    straight two-epoch run (DeepLabV3+ with its dropout and BatchNorm)."""
    first = build("segmentation", "resnet50", tmp_path / "a", "--epochs",
                  "1", "--lrs")
    first.fit()
    resumed = build("segmentation", "resnet50", tmp_path / "a", "--epochs",
                    "2", "--lrs")
    resumed.fit()
    assert resumed.start_epoch == 2
    straight = build("segmentation", "resnet50", tmp_path / "b", "--epochs",
                     "2", "--lrs")
    straight.fit()
    _assert_bitwise(_state(resumed), _state(straight))
    assert resumed.plateau.state_dict() == straight.plateau.state_dict()
    assert resumed.best_val == straight.best_val
    assert {"resumed_from_epoch", "best_val"} <= set().union(
        *_ledger(resumed.logger.jsonl_path))
    moved = [k for k, v in _state(first)[0].items()
             if not torch.equal(v, _state(straight)[0][k])]
    assert moved       # the second epoch changed the weights


def test_frozen_trains_only_the_head(tmp_path):
    """--frozen: the encoder's parameters bitwise unchanged (no update, no
    decay), its BatchNorm running statistics updated in train mode, the
    decoder's parameters moved; the optimizer holds only the trainable
    ones."""
    t = build("segmentation", "resnet50", tmp_path, "--epochs", "1",
              "--frozen")
    before = _state(t)[0]
    t.fit()
    after = t.model.state_dict()
    names = dict(t.model.named_parameters())
    frozen = [k for k in names if k.startswith("encoder.")]
    assert frozen and all(not names[k].requires_grad for k in frozen)
    for k, v in after.items():
        changed = not torch.equal(v, before[k])
        if k in names:
            assert changed == (k not in frozen), k
        elif k.startswith("encoder.") and "running" in k:
            assert changed, k
    held = {id(p) for g in t.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for k, p in names.items() if k not in frozen}


def _jax_models():
    """Each (task, arch)'s JAX model at the port's narrow widths."""
    rn = functools.partial(jres.ResNet50, stage_sizes=TINY)
    return {
        ("classification", "vit_b"): (JaxViTClassifier(num_classes=6,
                                                       **VIT), 224,
                                      lambda p, s:
                                      conv.vit_classifier_params_to_torch(p)),
        ("segmentation", "vit_b"): (JaxDense("seg"), 224,
                                    conv.vit_dense_params_to_torch),
        ("depth", "vit_b"): (JaxDense("depth"), 224,
                             conv.vit_dense_params_to_torch),
        ("classification", "resnet50"): (jres.ResNetClassifier(6), 64,
                                         conv.resnet_classifier_params_to_torch),
        ("segmentation", "resnet50"): (jdl.DeepLabV3Plus(1), 64,
                                       conv.deeplabv3plus_params_to_torch),
        ("depth", "resnet50"): (jres.ResNetDepthModel(), 64,
                                conv.resnet_depth_params_to_torch),
    }, rn


@pytest.mark.parametrize("key", list(WIDTHS), ids="-".join)
def test_frozen_set_is_the_jax_packages(key, monkeypatch):
    """The parameters --frozen freezes are those whose JAX path starts with
    backbone/encoder (`tasks/build.py:259-262`), for every model: the JAX
    tree, each leaf marked 1 under those names and 0 elsewhere, converted
    by the port's converter, marks exactly the frozen port parameters."""
    models, rn = _jax_models()
    monkeypatch.setattr(jres, "ResNet50", rn)
    monkeypatch.setattr(jdl, "ResNet50", rn)
    jmodel, size, to_torch = models[key]
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, size, size, 3))))
    mark = lambda tree, frozen: jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(
            frozen(path[0].key)), np.float32), tree)
    params = mark(shapes["params"],
                  lambda top: top.startswith(("backbone", "encoder")))
    stats = mark(shapes.get("batch_stats", {}), lambda top: False)
    marks = to_torch(params, stats)
    port = build_model(Task(key[0]), Architecture(key[1]),
                       num_classes=6 if key[0] == "classification" else 1,
                       img_size=size, device="cpu", **WIDTHS[key])
    trainable = {id(p) for p in freeze_body(port)}
    for name, p in port.named_parameters():
        assert marks[name].shape == p.shape
        assert bool(marks[name].all()) == (not p.requires_grad), name
        assert bool(marks[name].any()) == (id(p) not in trainable), name


def test_plateau_reduction_lands_in_every_param_group(tmp_path):
    """With two param groups (decay and no decay), the plateau's reduced
    LR is written into both."""
    cfg = port_config("classification", "vit_b", tmp_path, "--epochs", "2",
                      "--lr", "0", "--lrs", n=8)
    cfg.optim.plateau_patience = 0
    t = tbuild.build_trainer(cfg, **VIT)
    t.optimizer = make_adamw(t.model.parameters(), 0.0,
                             decay_mask=lambda p: p.ndim > 1)
    t.fit()
    assert [g["lr"] for g in t.optimizer.param_groups] == [1e-6, 1e-6]
    assert {"lr_reduced_to"} <= set().union(*_ledger(t.logger.jsonl_path))


def test_nan_loss_aborts(tmp_path):
    t = build("classification", "resnet50", tmp_path, "--epochs", "1")
    t.full_step = lambda *a: {"loss": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="epoch 1 step 1"):
        t.fit()


def test_generators_keep_the_augmentation_on_the_host():
    """The augmentation's generator is a host one even for a run on the
    card: a card generator's `randperm(...).tolist()` would sync the device
    every step. Per epoch, seeded from (seed, epoch); without dropout the
    model draws from the same generator."""
    t = object.__new__(ttrainer.Trainer)
    t.seed, t.device = 42, torch.device("cuda")
    t.task = tbuild.make_task_definition(
        port_config("depth", "resnet50", "."), {}, "cpu")[0]
    aug, model_gen = t.generators(3)
    assert aug.device.type == "cpu" and model_gen is aug
    assert aug.initial_seed() == ttrainer.epoch_seed(42, 3)
    assert len({ttrainer.epoch_seed(s, e) for s in (0, 42)
                for e in range(4)}) == 8


# ------------------------------------------------------------ preemption

def test_preempt_during_val_saves_and_resumes(tmp_path):
    """SIGTERM during epoch 1's val pass: the run stops at the next epoch
    boundary with a requeue slot; a relaunch resumes past epoch 1 and, once
    it trains past the slot, deletes it."""
    mk = lambda: build("classification", "resnet50", tmp_path, "--epochs",
                       "3", "--lrs")
    trainer = mk()
    calls = {"n": 0}
    orig_eval = trainer.evaluate

    def eval_and_preempt(loader, epoch, split):
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig_eval(loader, epoch, split)

    trainer.evaluate = eval_and_preempt
    with pytest.raises(Preempted):
        trainer.fit()
    assert trainer.preempt_ckpt.exists()
    assert trainer.preempt_ckpt.path.endswith(".preempt.pt")
    assert trainer.preempt_ckpt.meta()["epoch"] == 1

    trainer2 = mk()
    trainer2.maybe_resume()
    assert trainer2.start_epoch == 2 and trainer2.best_val is not None

    trainer3 = mk()
    assert trainer3.fit() is not None
    assert trainer3.ckpt.exists() and not trainer3.preempt_ckpt.exists()
    assert REQUEUE_EXIT_CODE == 42


def test_mid_epoch_preempt_saves_boundary_state(tmp_path):
    """A signal in the middle of epoch 1 saves the state of the last epoch
    BOUNDARY (the initial weights and an untouched optimizer), not the
    half-updated one, so that the replayed epoch applies no batch twice."""
    trainer = build("classification", "resnet50", tmp_path, "--epochs", "2")
    orig_step = trainer.full_step
    calls = {"n": 0}

    def step_and_preempt(*args):
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            signal.getsignal(signal.SIGTERM)
        return orig_step(*args)

    init = _state(trainer)
    trainer.full_step = step_and_preempt
    with pytest.raises(Preempted):
        trainer.fit()
    assert calls["n"] == 1
    saved = trainer.preempt_ckpt.restore()
    assert saved["meta"]["epoch"] == 0
    _assert_bitwise(saved["model"], init[0])
    _assert_bitwise(saved["optimizer"], init[1])
    moved = trainer.model.state_dict()
    assert any(not torch.equal(moved[k], v) for k, v in init[0].items())


def test_cli_exits_42_on_preemption(tmp_path, monkeypatch):
    monkeypatch.setattr(tcli_train, "build_trainer", functools.partial(
        tbuild.build_trainer, stage_sizes=TINY))
    orig = ttrainer.Trainer.train_epoch

    def preempted_epoch(self, epoch):
        os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, epoch)

    monkeypatch.setattr(ttrainer.Trainer, "train_epoch", preempted_epoch)
    with pytest.raises(SystemExit) as e:
        tcli_train.main(_argv("classification", "resnet50", tmp_path) +
                        ["--device", "cpu"])
    assert e.value.code == REQUEUE_EXIT_CODE == 42


# ------------------------------------------------------------ CLIs

def test_clis_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = ["--task", "classification", "--synthetic", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli_train.main(argv)
    # the detection driver too builds on the card unless told otherwise
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli_train.main(["--task", "detection", "--synthetic", "--ckpt-dir",
                         str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="train first"):
        tcli_eval.main(argv + ["--device", "cpu"])


# a subprocess drives the CLIs as a user does; the config and the model are
# cut to test size by patching to_train_config and build_model before the
# CLI module runs
_SMALL = """
import functools, runpy, sys
from ssl4gie_tpu_torch.cli import args
from ssl4gie_tpu_torch.models import factory
full = args.to_train_config
def small(a):
    cfg = full(a)
    cfg.data.synthetic_size, cfg.data.img_size = 12, 64
    cfg.data.num_workers = 2
    return cfg
args.to_train_config = small
factory.build_model = functools.partial(factory.build_model,
                                        stage_sizes=(1, 1, 1, 1))
sys.argv = {argv!r}
runpy.run_module({module!r}, run_name="__main__")
"""


def _run_cli(module, argv, cwd):
    code = _SMALL.format(argv=[module] + argv, module=module)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return r.stdout


def test_cli_train_then_evaluate_subprocess(tmp_path):
    """`python -m ssl4gie_tpu_torch.cli.train --epochs 1` then
    `cli.evaluate` on the CPU for RN50 segmentation, as
    `tests/test_cli.py` drives the JAX CLIs: the best-val slot is
    `<ckpt_dir>/<run_name>.pt` and the ledger gets the Dice lines."""
    common = ["--task", "segmentation", "--architecture", "resnet50",
              "--synthetic", "--batch-size", "4", "--compute-dtype",
              "float32", "--device", "cpu", "--ckpt-dir",
              os.path.join(str(tmp_path), "ckpt")]
    out = _run_cli("ssl4gie_tpu_torch.cli.train", common + ["--epochs", "1"],
                   REPO)
    assert "best val performance" in out
    assert os.path.isfile(os.path.join(
        str(tmp_path), "ckpt",
        "resnet50-random_init-frozen_False-dataset_.pt"))
    out = _run_cli("ssl4gie_tpu_torch.cli.evaluate",
                   common + ["--results-root", str(tmp_path),
                             "--print-list"], REPO)
    for key in ("Dice:", "IoU:", "Precision:", "Recall:",
                "RN_NA_NA_ = ["):
        assert key in out
    assert os.path.exists(os.path.join(str(tmp_path), "eval_results.txt"))


@pytest.mark.parametrize("key", list(WIDTHS), ids="-".join)
def test_train_resume_evaluate_every_task(key, tmp_path):
    """Each task on both architectures: one epoch, a resumed second, then
    the evaluation CLI's path (the best-val slot loaded into a fresh model,
    the held-out evaluator) prints finite results."""
    task, arch = key
    first = build(task, arch, tmp_path, "--epochs", "1", "--lrs", n=12)
    first.fit()
    second = build(task, arch, tmp_path, "--epochs", "2", "--lrs", n=12)
    second.fit()
    assert second.start_epoch == 2 and second.best_val is not None
    cfg = port_config(task, arch, tmp_path, n=12)
    model, extras = tcli_eval.load_eval_state(cfg, **WIDTHS[key])
    best = second.ckpt.restore()["model"]
    _assert_bitwise(model.state_dict(), best)
    src = tcli_eval.make_test_source(cfg)
    root = str(tmp_path)
    if task == "classification":
        res = teval.evaluate_classification(cfg, model, src, 6, root)
    elif task == "segmentation":
        res = teval.evaluate_segmentation(cfg, model, src, root)
    else:
        res = teval.evaluate_depth(cfg, model, src, root)
    assert all(np.isfinite(v) for v in res.values()) and len(res) >= 3
