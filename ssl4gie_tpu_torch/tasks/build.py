"""Assemble a Trainer from a TrainConfig (port of `ssl4gie_tpu/tasks/
build.py`): data discovery and the split, the model, the optimizer, the
loss and metric wiring, the Loaders, the logger, the checkpoint and the
plateau schedule, as each reference build() does
(`train_classification.py:128-248`, `train_segmentation.py:125-223`,
`train_depth.py:131-251`, `train_detection.py:169-300`), and the SSL
finetune recipes of the JAX package (`tasks/build.py:69-118,198-240`): the
pretrained load (`--checkpoint`, `--pretraining ImageNet_class`) before the
optimizer is built, the linear probes (`--probe`), the timm augmentation
(`--aa`, `--reprob`), label smoothing and mixup/cutmix with the soft-target
loss, and AdamW with layer decay (`--layer-decay`).

Over several processes (`core/mesh.py:maybe_init_distributed`) the build
lays out the mesh as the JAX package's does (`tasks/build.py:149-247`):
the ("data",) mesh, or the ("data", "model") mesh of `--tensor-parallel`
(`parallel/tp.py:make_tp_mesh`), with its refusals (TP or FSDP with
detection, TP with an explicit mesh shape or with resnet50) and the
global batch's divisibility by the data size; then places the model
(`make_place_fn`: DDP, FSDP2, TP or both) before the optimizer is built
over the placed parameters, and gives each Loader its rank's part of the
batch."""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ssl4gie_tpu_torch.core import checkpoint as ckpt_lib
from ssl4gie_tpu_torch.convert.loaders import (load_imagenet_supervised,
                                               load_pretrained)
from ssl4gie_tpu_torch.core.config import (Architecture, Pretraining,
                                           SSLFramework, Task, TrainConfig,
                                           compute_dtype)
from ssl4gie_tpu_torch.core.logger import MetricsLogger
from ssl4gie_tpu_torch.core.mesh import (axis_shard, axis_size,
                                         local_batch_size, make_mesh)
from ssl4gie_tpu_torch.core.schedule import ReduceLROnPlateau
from ssl4gie_tpu_torch.core.train_state import (freeze, freeze_body,
                                                make_adamw)
from ssl4gie_tpu_torch.core.trainer import (TaskDefinition, Trainer,
                                            epoch_seed)
from ssl4gie_tpu_torch.data import discovery, randaug
from ssl4gie_tpu_torch.data.augment import mixup_cutmix, sample_mixup_params
from ssl4gie_tpu_torch.data.loader import (ClassificationSource, DepthSource,
                                           Loader, SegmentationSource,
                                           SyntheticSource)
from ssl4gie_tpu_torch.data.splits import split_ids
from ssl4gie_tpu_torch.metrics import classification as cls_metrics
from ssl4gie_tpu_torch.models.factory import build_model
from ssl4gie_tpu_torch.models.layers import default_device
from ssl4gie_tpu_torch.parallel.distributed import unwrap
from ssl4gie_tpu_torch.parallel.tp import make_place_fn, make_tp_mesh
from ssl4gie_tpu_torch.ssl.lr_decay import layer_decay_groups
from ssl4gie_tpu_torch.ssl.probe import (make_probe_optimizer,
                                         probe_head_trainable, reinit_head)
from ssl4gie_tpu_torch.tasks.depth import depth_task
from ssl4gie_tpu_torch.tasks.detection import (TV_CANVAS, DetectionSource,
                                               DetectionTrainer,
                                               SyntheticDetectionSource)
from ssl4gie_tpu_torch.tasks.segmentation import segmentation_task

# the reduced proposal counts of a synthetic (256 px) detection run, train
# and test, and the test-time half of them (`cli/evaluate.py`)
SYNTHETIC_DET_TEST = dict(rpn_pre_nms_top_n_test=100,
                          rpn_post_nms_top_n_test=50, detections_per_img=10)
SYNTHETIC_DET = dict(rpn_pre_nms_top_n_train=200, rpn_post_nms_top_n_train=100,
                     box_batch_size_per_image=64, **SYNTHETIC_DET_TEST)


def _subset(lst, idx):
    return [lst[i] for i in idx]


def _make_sources(cfg: TrainConfig):
    """(train_source, val_source, test_source, extras dict)."""
    d = cfg.data
    if d.synthetic:
        mk = lambda seed: SyntheticSource(d.synthetic_size, d.img_size,
                                          cfg.task.value, seed=seed)
        extras = ({"n_class": 6, "class_weights": [1.0] * 6}
                  if cfg.task == Task.CLASSIFICATION else {})
        return mk(0), mk(1), mk(2), extras

    if cfg.task == Task.CLASSIFICATION:
        data = discovery.discover_classification(d.data_root, d.dataset)
        tr, te, va = split_ids(len(data.input_paths))
        mk = lambda idx: ClassificationSource(_subset(data.input_paths, idx),
                                              _subset(data.targets, idx),
                                              d.img_size)
        return mk(tr), mk(va), mk(te), {"n_class": data.n_class,
                                        "class_weights": data.class_weights}

    if cfg.task == Task.SEGMENTATION:
        imgs, masks = discovery.discover_segmentation(d.data_root, d.dataset)
        tr, te, va = split_ids(len(imgs))
        mk = lambda idx: SegmentationSource(_subset(imgs, idx),
                                            _subset(masks, idx), d.img_size)
        return mk(tr), mk(va), mk(te), {}

    if cfg.task == Task.DEPTH:
        splits = discovery.discover_depth(d.data_root)
        mk = lambda s: DepthSource(*splits[s], d.img_size)
        return mk("train"), mk("val"), mk("test"), {}

    raise ValueError(f"no finetune sources for {cfg.task}")


def make_mixer(n_class: int, mixup: float, cutmix: float,
               smoothing: float, accum_steps: int = 1) -> Callable:
    """The MAE finetune recipe's mixer (`main_finetune.py:219-226`) as a
    task's `mixup_fn`: labels -> label-smoothed one-hot targets, then, when
    either alpha is positive, mixup/cutmix of images and targets at one
    batch's draws from the generator (with the global batch's partners
    under data parallelism; `accum_steps` is the step's microbatch
    count)."""
    def mixer(img, labels, generator):
        soft = cls_metrics.smooth_one_hot(labels, n_class, smoothing)
        if mixup <= 0 and cutmix <= 0:
            return img, soft
        params = sample_mixup_params(generator, img.shape[1], img.shape[2],
                                     mixup, cutmix)
        return mixup_cutmix(img, soft, params, accum_steps)
    return mixer


def make_task_definition(cfg: TrainConfig, extras: dict, device
                         ) -> Tuple[TaskDefinition, Optional[Callable]]:
    """The task and, for classification, the finalizer of its accumulated
    predictions (meanF1). Classification takes the probe's transform or
    the timm stack as its `aug_fn`, and with --mixup/--cutmix/--smoothing
    the mixer and the soft-target loss; evaluation keeps the int labels
    and argmax meanF1."""
    if cfg.task == Task.CLASSIFICATION:
        n_class = extras["n_class"]
        o = cfg.optim
        size = cfg.data.img_size
        aug_fn = None
        if cfg.probe:
            # RRC + hflip + normalize only (`main_lincls.py:273-274`,
            # `main_linprobe.py:133-134`)
            aug_fn = randaug.make_probe_aug(size, o.accum_steps)
        elif o.auto_augment or o.reprob > 0:
            aug_fn = randaug.make_timm_aug(size, o.auto_augment or "",
                                           o.reprob, o.accum_steps)
        mixup_fn = None
        if o.mixup > 0 or o.cutmix > 0 or o.label_smoothing > 0:
            mixup_fn = make_mixer(n_class, o.mixup, o.cutmix,
                                  o.label_smoothing, o.accum_steps)
            loss_fn = cls_metrics.soft_target_cross_entropy
        else:
            weights = torch.tensor(extras["class_weights"],
                                   dtype=torch.float32, device=device)
            loss_fn = functools.partial(cls_metrics.weighted_cross_entropy,
                                        class_weights=weights)
        td = TaskDefinition(
            name="classification", aug_mode="classification",
            target_key="label", loss_fn=loss_fn,
            eval_kind="accumulate_preds", select_mode="max",
            has_dropout=o.drop_path > 0,   # stochastic depth draws
            aug_fn=aug_fn, mixup_fn=mixup_fn)
        return td, lambda preds, targets: cls_metrics.mean_f1(
            preds, targets, n_class)
    if cfg.task == Task.SEGMENTATION:
        return segmentation_task(), None
    if cfg.task == Task.DEPTH:
        return depth_task(), None
    raise ValueError(f"no task definition for {cfg.task}")


def make_run_mesh(cfg: TrainConfig, num_heads: int = 12):
    """(mesh, TP active, FSDP) of a finetune run, with the JAX package's
    refusals and the batch's divisibility check (`ssl4gie_tpu/tasks/
    build.py:149-179`); `num_heads` is the ViT's head count, which the
    tensor-parallel size must divide. The mesh is None for one process."""
    rt = cfg.runtime
    tp, fsdp = rt.tensor_parallel, rt.fsdp
    if (tp > 1 or fsdp) and cfg.task == Task.DETECTION:
        raise ValueError("--tensor-parallel/--fsdp support the ViT dense/"
                         "pooled tasks (classification/segmentation/depth) "
                         "and SSL pretraining; use pure data parallelism for "
                         "detection")
    if tp > 1:
        if rt.mesh_shape is not None:
            raise ValueError("give either tensor_parallel or an explicit "
                             "mesh_shape/mesh_axes, not both")
        if cfg.architecture == Architecture.RESNET50:
            raise ValueError("--tensor-parallel requires a ViT architecture; "
                             "use --fsdp or pure data parallelism for "
                             "resnet50")
        mesh = make_tp_mesh(tp, num_heads, device=rt.device)
    else:
        mesh = make_mesh(rt.mesh_shape, rt.mesh_axes, rt.device)
    local_batch_size(cfg.data.batch_size, mesh)
    return mesh, axis_size(mesh, "model") > 1, fsdp


def build_trainer(cfg: TrainConfig, **widths) -> Trainer:
    """The Trainer of `cfg`, on `cfg.runtime.device` (the card unless
    "cpu"; this rank's card under a process group). `widths` narrow the
    model (`models/factory.py:build_model`), for tests."""
    cfg.validate()
    mesh, tp, fsdp = make_run_mesh(cfg, widths.get("num_heads", 12))
    if cfg.task == Task.DETECTION:
        return _build_detection_trainer(cfg, mesh, **widths)
    device = default_device(cfg.runtime.device)
    train_src, val_src, test_src, extras = _make_sources(cfg)
    td, finalize = make_task_definition(cfg, extras, device)

    dtype = compute_dtype(cfg.runtime)
    probe_bn = cfg.probe and cfg.ss_framework == SSLFramework.MAE
    model = build_model(cfg.task, cfg.architecture,
                        num_classes=extras.get("n_class", 1),
                        pretraining=cfg.pretraining,
                        framework=cfg.ss_framework, out_token=cfg.out_token,
                        img_size=cfg.data.img_size, dtype=dtype,
                        drop_path=cfg.optim.drop_path,
                        generator=torch.Generator().manual_seed(
                            cfg.runtime.seed),
                        probe_bn=probe_bn, device=device, **widths)
    load_backbone(cfg, model)
    prepare_trainable(cfg, model)
    model = make_place_fn(mesh, tp=tp, fsdp=fsdp)(model)
    optimizer = make_optimizer(cfg, model)
    o = cfg.optim

    bs, seed, threads = (cfg.data.batch_size, cfg.runtime.seed,
                         cfg.data.num_workers)
    shard = axis_shard(mesh)
    train_loader = Loader(train_src, bs, shuffle=True, drop_last=True,
                          seed=seed, num_threads=threads, shard=shard,
                          accum_steps=o.accum_steps)
    val_loader = Loader(val_src, bs, shuffle=False, drop_last=False,
                        seed=seed, num_threads=threads, shard=shard)
    test_loader = Loader(test_src, bs, shuffle=False, drop_last=False,
                         seed=seed, num_threads=threads, shard=shard)

    logger = MetricsLogger(cfg.log_dir, cfg.run_name(),
                           tb=cfg.runtime.tensorboard)
    ckpt = ckpt_lib.CheckpointManager(cfg.ckpt_dir, cfg.run_name())
    plateau = None
    if o.use_plateau_scheduler:
        plateau = ReduceLROnPlateau(mode=td.select_mode,
                                    factor=o.plateau_factor,
                                    patience=o.plateau_patience,
                                    min_lr=o.min_lr)
    return Trainer(task=td, model=model, optimizer=optimizer, device=device,
                   train_loader=train_loader, val_loader=val_loader,
                   test_loader=test_loader, logger=logger, ckpt=ckpt,
                   epochs=cfg.epochs, accum_steps=o.accum_steps, seed=seed,
                   plateau=plateau, eval_finalize=finalize,
                   log_every=cfg.runtime.log_every)


def load_backbone(cfg: TrainConfig, model: torch.nn.Module) -> None:
    """The pretrained start: cfg.checkpoint, or the supervised ImageNet
    file of `--pretraining ImageNet_class`, into the model's backbone
    (`convert/loaders.py`); nothing for a random start."""
    if cfg.checkpoint:
        load_pretrained(cfg, model)
    elif cfg.pretraining == Pretraining.IMAGENET_CLASS:
        load_imagenet_supervised(cfg, model)


# the probe head's re-init draws from its own seed, (seed, PROBE_STREAM)
PROBE_STREAM = 7


def prepare_trainable(cfg: TrainConfig, model: torch.nn.Module) -> None:
    """Before the model is placed: the linear probe's head re-initialised
    and everything else frozen, or with --frozen the encoder frozen (a
    placement reduces the gradients of what still trains)."""
    if cfg.probe:
        reinit_head(model, torch.Generator().manual_seed(
            epoch_seed(cfg.runtime.seed, PROBE_STREAM)))
        freeze(model, probe_head_trainable)
    elif cfg.frozen:
        freeze_body(model)


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module
                   ) -> torch.optim.Optimizer:
    """The linear probe's optimizer on its head (`main_lincls.py:158-166,
    233-237`, `main_linprobe.py:219-252`), or AdamW over the trainable
    parameters (the heads/decoders only with --frozen, as the reference
    freezes the encoder, `Models/models.py:138-140`), with --layer-decay in
    one param group per layer scale over the backbone's depth. `model` may
    be placed; `prepare_trainable` ran before."""
    o = cfg.optim
    model = unwrap(model)
    if cfg.probe:
        return make_probe_optimizer(cfg.ss_framework, model, o.learning_rate)
    params = freeze_body(model) if cfg.frozen else list(model.parameters())
    if o.layer_decay is not None:
        blocks = getattr(getattr(model, "backbone", None), "blocks", ())
        params = layer_decay_groups(model, depth=len(blocks) or 12,
                                    decay=o.layer_decay, trainable=params)
    return make_adamw(params, o.learning_rate, o.b1, o.b2, o.eps,
                      o.adamw_weight_decay, grad_clip=o.grad_clip)


def detection_canvas(cfg: TrainConfig) -> tuple[int, str]:
    """(canvas, placement) of a detection run: ViT-B on the reference's
    1024 px fixed canvas (`train_detection.py:250`); RN50 with torchvision's
    min/max resize onto the 1344 px canvas (`train_detection.py:197-204`);
    synthetic data on 256 px (a multiple of the ViT's 16-token window), or
    min(img_size, 256) for RN50."""
    vit = cfg.architecture == Architecture.VIT_B
    if cfg.data.synthetic:
        return (256 if vit else min(cfg.data.img_size, 256)), "fixed"
    return (1024, "fixed") if vit else (TV_CANVAS, "torchvision")


def _build_detection_trainer(cfg: TrainConfig, mesh=None,
                             **widths) -> DetectionTrainer:
    """The detection build (JAX `tasks/build.py:_build_detection_trainer`,
    `train_detection.py:169-300`): the Kvasir boxes JSON and the split,
    Faster R-CNN, AdamW, the mAP-selected checkpoint; data parallelism
    only (DDP over `mesh`). `widths` narrow the ViT (`FasterRCNN(depth=,
    embed_dim=, num_heads=)`), for tests."""
    d = cfg.data
    device = default_device(cfg.runtime.device)
    canvas, resize = detection_canvas(cfg)
    if d.synthetic:
        mk = lambda seed: SyntheticDetectionSource(d.synthetic_size, canvas,
                                                   seed)
        train_src, val_src, test_src = mk(0), mk(1), mk(2)
    else:
        paths, targets = discovery.discover_detection(d.data_root, d.dataset)
        tr, te, va = split_ids(len(paths))
        mk = lambda idx: DetectionSource(_subset(paths, idx), targets, canvas,
                                         resize=resize)
        train_src, val_src, test_src = mk(tr), mk(va), mk(te)

    dtype = compute_dtype(cfg.runtime)
    model = build_model(cfg.task, cfg.architecture,
                        pretraining=cfg.pretraining,
                        framework=cfg.ss_framework, img_size=canvas,
                        dtype=dtype,
                        generator=torch.Generator().manual_seed(
                            cfg.runtime.seed),
                        device=device,
                        **(SYNTHETIC_DET if d.synthetic else {}), **widths)
    # the encoder lands in the ViTDet backbone or the RN50-FPN body
    load_backbone(cfg, model)
    model = make_place_fn(mesh)(model)
    o = cfg.optim
    optimizer = make_adamw(model.parameters(), o.learning_rate, o.b1, o.b2,
                           o.eps, o.adamw_weight_decay, grad_clip=o.grad_clip)
    logger = MetricsLogger(cfg.log_dir, cfg.run_name(),
                           tb=cfg.runtime.tensorboard)
    ckpt = ckpt_lib.CheckpointManager(cfg.ckpt_dir, cfg.run_name())
    plateau = None
    if o.use_plateau_scheduler:
        plateau = ReduceLROnPlateau(mode="max", factor=o.plateau_factor,
                                    patience=o.plateau_patience,
                                    min_lr=o.min_lr)
    return DetectionTrainer(model=model, optimizer=optimizer, device=device,
                            train_source=train_src, val_source=val_src,
                            test_source=test_src, logger=logger, ckpt=ckpt,
                            epochs=cfg.epochs, batch_size=d.batch_size,
                            accum_steps=o.accum_steps, seed=cfg.runtime.seed,
                            num_threads=d.num_workers, plateau=plateau,
                            log_every=cfg.runtime.log_every,
                            shard=axis_shard(mesh))
