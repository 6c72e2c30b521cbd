"""CLI argument grammar (port of `ssl4gie_tpu/cli/args.py`): the JAX
package's flags, defaults and dest names, which are the reference drivers'
(README.md:81-119, `train_classification.py:372-411`) plus --task, and the
port's `--device`."""

from __future__ import annotations

import argparse

from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                           OptimConfig, Pretraining,
                                           RuntimeConfig, SSLFramework, Task,
                                           TrainConfig)


def add_common(p: argparse.ArgumentParser):
    p.add_argument("--task", type=str, required=True,
                   choices=[t.value for t in Task])
    p.add_argument("--architecture", "--arch", type=str, default="vit_b",
                   choices=["resnet50", "vit_b"], dest="architecture")
    p.add_argument("--pretraining", type=str, default="random",
                   choices=[x.value for x in Pretraining])
    p.add_argument("--ss-framework", type=str, default=None,
                   choices=[x.value for x in SSLFramework], dest="ss_framework")
    p.add_argument("--checkpoint", "--ckpt", type=str, default=None,
                   dest="checkpoint")
    p.add_argument("--frozen", action="store_true")
    p.add_argument("--probe", action="store_true",
                   help="linear-probe protocol (MoCo v3 / MAE)")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--data-root", type=str, default="", dest="data_root")
    p.add_argument("--batch-size", type=int, default=16, dest="batch_size")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (tests/benches, no files needed)")
    p.add_argument("--out-token", type=str, default="cls",
                   choices=["cls", "spatial", "global_pool"], dest="out_token")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"], dest="compute_dtype")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensorboard", action="store_true",
                   help="also emit tfevents scalars (core.tb)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where to run: the card (default) or the CPU")


def add_train(p: argparse.ArgumentParser):
    p.add_argument("--epochs", type=int, default=None,
                   help="default: 50 cls/depth, 200 seg/det (reference defaults)")
    p.add_argument("--learning-rate", "--lr", type=float, default=1e-4,
                   dest="learning_rate")
    # the reference flag is a bare store_true (`train_classification.py:405`);
    # accept both that form and an explicit true/false value
    p.add_argument("--learning-rate-scheduler", "--lrs", type=str, nargs="?",
                   const="true", default="false", dest="lrs")
    p.add_argument("--learning-rate-scheduler-minimum", "--lrs-min",
                   type=float, default=1e-6, dest="lrs_min")
    p.add_argument("--accum_iter", "--accum-iter", type=int, default=1,
                   dest="accum_iter")
    p.add_argument("--layer-decay", type=float, default=None,
                   dest="layer_decay",
                   help="layer-wise LR decay (MAE finetune recipe, 0.65)")
    p.add_argument("--mixup", type=float, default=0.0,
                   help="mixup alpha (MAE finetune recipe, 0.8)")
    p.add_argument("--cutmix", type=float, default=0.0,
                   help="cutmix alpha (MAE finetune recipe, 1.0)")
    p.add_argument("--smoothing", type=float, default=0.0,
                   dest="label_smoothing",
                   help="label smoothing (MAE finetune recipe, 0.1)")
    p.add_argument("--drop-path", "--drop_path", type=float, default=0.0,
                   dest="drop_path",
                   help="stochastic depth rate (ViT classification)")
    p.add_argument("--aa", type=str, default=None,
                   help="RandAugment policy, e.g. rand-m9-mstd0.5-inc1")
    p.add_argument("--reprob", type=float, default=0.0,
                   help="random erasing probability (MAE recipe, 0.25)")
    p.add_argument("--ckpt-dir", type=str, default="Trained models",
                   dest="ckpt_dir")
    p.add_argument("--tensor-parallel", "--tp", type=int, default=1,
                   dest="tensor_parallel",
                   help="Megatron-style tensor parallelism over this many "
                        "GPUs (ViT tasks; must divide the head count)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP2: shard parameters, gradients and optimizer "
                        "state over the data-parallel ranks")


def to_train_config(args) -> TrainConfig:
    task = Task(args.task)
    epochs = args.epochs
    if epochs is None:
        epochs = 50 if task in (Task.CLASSIFICATION, Task.DEPTH) else 200
    cfg = TrainConfig(
        task=task,
        architecture=Architecture(args.architecture),
        pretraining=Pretraining(args.pretraining),
        ss_framework=(SSLFramework(args.ss_framework) if args.ss_framework
                      else None),
        checkpoint=args.checkpoint,
        frozen=args.frozen,
        probe=getattr(args, "probe", False),
        epochs=epochs,
        out_token=args.out_token,
        data=DataConfig(dataset=args.dataset, data_root=args.data_root,
                        batch_size=args.batch_size, synthetic=args.synthetic),
        optim=OptimConfig(
            learning_rate=getattr(args, "learning_rate", 1e-4),
            use_plateau_scheduler=getattr(args, "lrs", "false") == "true",
            min_lr=getattr(args, "lrs_min", 1e-6),
            accum_steps=getattr(args, "accum_iter", 1),
            layer_decay=getattr(args, "layer_decay", None),
            mixup=getattr(args, "mixup", 0.0),
            cutmix=getattr(args, "cutmix", 0.0),
            label_smoothing=getattr(args, "label_smoothing", 0.0),
            drop_path=getattr(args, "drop_path", 0.0),
            auto_augment=getattr(args, "aa", None),
            reprob=getattr(args, "reprob", 0.0)),
        runtime=RuntimeConfig(seed=args.seed, compute_dtype=args.compute_dtype,
                              tensorboard=getattr(args, "tensorboard", False),
                              tensor_parallel=getattr(args, "tensor_parallel",
                                                      1),
                              fsdp=getattr(args, "fsdp", False),
                              device=args.device),
        ckpt_dir=getattr(args, "ckpt_dir", "Trained models"),
        log_dir=getattr(args, "ckpt_dir", "Trained models"),
    )
    return cfg.validate()
