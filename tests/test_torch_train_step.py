"""The slice as a whole: one float32 train step of the port
(`ssl4gie_tpu_torch.core.trainer.make_train_step`) against the JAX package's
`make_train_step`, at the same weights and on the same augmented batch, plus
the port's import hygiene (no jax/flax/optax)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4gie_tpu.core.train_state import TrainState
from ssl4gie_tpu.core.train_state import make_adamw as jax_make_adamw
from ssl4gie_tpu.core.trainer import TaskDefinition as JaxTask
from ssl4gie_tpu.core.trainer import make_train_step as jax_make_train_step
from ssl4gie_tpu.data.augment import augment_train_batch
from ssl4gie_tpu.metrics.classification import \
    weighted_cross_entropy as jax_wce
from ssl4gie_tpu.models.vit import ViTClassifier as JaxViTClassifier
from ssl4gie_tpu_torch.convert.from_jax import vit_classifier_params_to_torch
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_train_step
from ssl4gie_tpu_torch.data.augment import apply_classification
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from test_torch_augment import jax_classification_params

torch.set_num_threads(1)

B, DIM, HEADS, DEPTH, CLASSES = 4, 64, 4, 2, 6
LR, B1 = 1e-3, 0.9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    """Weights, the raw batch and both packages' augmented batches."""
    model = JaxViTClassifier(num_classes=CLASSES, dtype=jnp.float32,
                             depth=DEPTH, embed_dim=DIM, num_heads=HEADS)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32))["params"])
    rng = np.random.default_rng(0)
    img_u8 = rng.integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, size=B).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jax_img, _ = augment_train_batch(key, jnp.asarray(img_u8),
                                     mode="classification", exact=False,
                                     per_image_jitter=False)
    torch_img = apply_classification(torch.from_numpy(img_u8),
                                     jax_classification_params(key, B))
    return model, params, jax_img, torch_img, labels


def _adam_mu(opt_state):
    """The first moment tree inside the optax chain state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no adam state found")


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(setup, accum_steps):
    model, params, jax_img, torch_img, labels = setup
    np.testing.assert_allclose(torch_img.numpy(), np.asarray(jax_img),
                               rtol=5e-5, atol=5e-5)

    td = JaxTask(name="classification", aug_mode="classification",
                 target_key="label", loss_fn=jax_wce, eval_metric_fn=None)
    # the step donates its state: hand it fresh device arrays
    state = TrainState.create(model.apply,
                              jax.tree_util.tree_map(jnp.array, params),
                              jax_make_adamw(LR), {})
    step = jax_make_train_step(td, accum_steps=accum_steps, top_level=False)
    new_state, metrics = step(state, {"image": jax_img,
                                      "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(1))
    # on Adam's first step mu = (1 - b1) * g: the step's averaged gradient
    jax_grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1),
                                       _adam_mu(new_state.opt_state))

    tmodel = ViTClassifier(CLASSES, depth=DEPTH, embed_dim=DIM,
                           num_heads=HEADS, device="cpu")
    tmodel.load_state_dict(vit_classifier_params_to_torch(params))
    opt = make_adamw(tmodel.parameters(), LR)
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label", loss_fn=weighted_cross_entropy)
    out = make_train_step(task, accum_steps)(
        tmodel, opt, {"image": torch_img, "label": torch.from_numpy(labels)})

    np.testing.assert_allclose(out["loss"].item(), float(metrics["loss"]),
                               rtol=1e-5)
    ref_g = vit_classifier_params_to_torch(jax_grads)
    ref_p = vit_classifier_params_to_torch(
        jax.tree_util.tree_map(np.asarray, new_state.params))
    named = dict(tmodel.named_parameters())
    assert set(named) == set(ref_g)
    diffs = []
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        diffs.append(np.abs(p.detach().numpy() - ref_p[name].numpy()).ravel())
    # Adam's first update is about lr * sign(g): a gradient within rounding
    # of 0 can take either sign in the two packages and move the weight by up
    # to 2 * lr apart (the key bias, whose exact gradient is 0 because softmax
    # ignores a per-row shift, is all such elements). Bound every element by
    # that and require 99.9% of all elements to agree to 1e-6.
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * (1 + 1e-3)
    assert np.mean(diffs <= 1e-6) >= 0.999


@pytest.mark.parametrize("weighted", [False, True])
def test_classification_metrics_match_jax(weighted):
    """Weighted cross-entropy and the per-class metrics against the JAX
    package's, on the same logits, labels and predictions."""
    from ssl4gie_tpu.metrics import classification as jm
    from ssl4gie_tpu_torch.metrics import classification as tm

    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (32, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 32).astype(np.int32)
    preds = rng.integers(0, CLASSES, 32).astype(np.int32)
    w = rng.uniform(0.5, 2.0, CLASSES).astype(np.float32) if weighted else None
    ref = jm.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if w is None else jnp.asarray(w))
    out = tm.weighted_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    tp, tl = torch.from_numpy(preds), torch.from_numpy(labels)
    jp, jl = jnp.asarray(preds), jnp.asarray(labels)
    for name in ("mean_f1", "mean_precision", "mean_recall"):
        np.testing.assert_allclose(getattr(tm, name)(tp, tl, CLASSES).item(),
                                   float(getattr(jm, name)(jp, jl, CLASSES)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tm.accuracy(tp, tl).item(),
                               float(jm.accuracy(jp, jl)), rtol=1e-6)


def test_adamw_lr_and_clip_match_optax():
    """`make_adamw` with a global-norm clip, `set_lr`/`get_lr` between two
    steps, against the JAX package's optax chain on the same arrays."""
    import optax

    from ssl4gie_tpu.core.train_state import get_lr as jax_get_lr
    from ssl4gie_tpu.core.train_state import set_lr as jax_set_lr
    from ssl4gie_tpu_torch.core.train_state import (apply_gradients, get_lr,
                                                    set_lr)

    rng = np.random.default_rng(3)
    params = {"w": rng.normal(0, 1, (8, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 4, v.shape).astype(np.float32)   # norm >> 1
              for k, v in params.items()} for _ in range(2)]
    lrs = (1e-2, 5e-3)

    tx = jax_make_adamw(lrs[0], grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for i, g in enumerate(grads):
        if i:
            state = jax_set_lr(state, lrs[i])
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    assert jax_get_lr(state) == pytest.approx(lrs[1])

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_adamw(tp.values(), lrs[0], grad_clip=1.0)
    for i, g in enumerate(grads):
        if i:
            set_lr(opt, lrs[i])
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        apply_gradients(opt)
    assert get_lr(opt) == pytest.approx(lrs[1])
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_adamw_clip_with_decay_mask_matches_optax():
    """`make_adamw(grad_clip=, decay_mask=)`: two param groups, clipped by
    one global norm over both, as the JAX `make_adamw(grad_clip=, mask=)`
    puts one `clip_by_global_norm` before adamw. The groups' gradient norms
    differ (about 4 and 40), so clipping each group by its own norm would
    not match."""
    import optax

    from ssl4gie_tpu_torch.core.train_state import apply_gradients

    rng = np.random.default_rng(4)
    params = {"w": rng.normal(0, 1, (8, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    scales = {"w": 0.6, "b": 18.0}
    grads = [{k: rng.normal(0, scales[k], v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    lr, wd = 1e-2, 0.05

    tx = jax_make_adamw(lr, weight_decay=wd, grad_clip=1.0,
                        mask={"w": True, "b": False})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_adamw(tp.values(), lr, weight_decay=wd, grad_clip=1.0,
                     decay_mask=lambda p: p.ndim > 1)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1]
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        apply_gradients(opt)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_port_imports_no_jax():
    """Importing every module of the port in a fresh interpreter, the
    detection, MAE, segmentation, ResNet-50 and depth modules, the
    detection evaluation's, the finetune driver's, the pretraining
    driver's (MoCo v3, LARS, the pretrain CLI), the predictors, the
    predict CLI, the native loader, the SSL recipes (RandAugment, layer
    decay, the probes, the transfer datasets) and checkpoint ingestion (the
    loaders, the facade, the convert CLI) and the multi-GPU layer (the
    mesh, the process group, tensor parallelism and the placements) and
    the NMS kernel's wrapper and benchmark among them, leaves jax, flax,
    optax and the JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ssl4gie_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 40, names\n"
        "for m in ('kernels.dense_attention', 'kernels.window_attention',"
        " 'kernels.flash_attention',"
        " 'ops.boxes', 'ops.nms', 'ops.resize', 'ops.roi_align',"
        " 'models.vitdet_fpn', 'models.rpn', 'models.roi_heads',"
        " 'models.faster_rcnn', 'tasks.detection', 'kernels.fused_mlp',"
        " 'ssl.mae', 'ssl.pretrain', 'data.ssl_augment', 'models.batchnorm',"
        " 'models.dpt', 'models.factory', 'metrics.segmentation',"
        " 'tasks.segmentation', 'benchmarks.bench_rotate', 'models.resnet',"
        " 'models.deeplabv3plus', 'metrics.depth', 'tasks.depth',"
        " 'metrics.detection', 'data.loader', 'data.discovery',"
        " 'core.config', 'cli.args', 'data.splits', 'core.schedule',"
        " 'core.logger', 'core.tb', 'core.preempt', 'core.checkpoint',"
        " 'core.train_state', 'core.trainer', 'tasks.build', 'cli.train',"
        " 'tasks.evaluate', 'cli.evaluate', 'ssl.moco_v3', 'ssl.lars',"
        " 'cli.pretrain', 'tasks.predict', 'tasks.colormaps', 'cli.predict',"
        " 'data.native_loader', 'data.augment', 'data.randaug',"
        " 'data.transfer', 'ssl.lr_decay', 'ssl.probe',"
        " 'convert.torch_names', 'convert.loaders', 'utils', 'cli.convert',"
        " 'core.mesh', 'parallel.distributed', 'parallel.tp',"
        " 'benchmarks.ablate_resident_backward', 'kernels.layer_norm',"
        " 'kernels.nms', 'benchmarks.bench_nms'):\n"
        "    assert pkg.__name__ + '.' + m in names, m\n"
        "print(sorted(m for m in ('jax', 'flax', 'optax', 'ssl4gie_tpu')"
        " if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
