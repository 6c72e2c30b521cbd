"""SSL pretraining CLI (port of `ssl4gie_tpu/cli/pretrain.py`, the vendored
main_moco.py / main_pretrain.py): the JAX CLI's flags, defaults, choices
and checks, plus `--device`.

  python -m ssl4gie_tpu_torch.cli.pretrain --framework mae --arch vit_b \\
      --data-root /path/Hyperkvasir-unlabelled --epochs 400 --batch-size 768
  python -m ssl4gie_tpu_torch.cli.pretrain --framework mocov3 --arch vit_s \\
      --synthetic --device cpu --compute-dtype float32 --epochs 1

Runs on the card unless `--device cpu`; on N GPUs under torchrun (or
SLURM / OpenMPI), one process each:
  torchrun --nproc-per-node 2 -m ssl4gie_tpu_torch.cli.pretrain \\
      --framework mae --arch vit_b --synthetic --batch-size 64 --tp 2
On a preemption signal the process
exits with code 42 (after the epoch's save, or mid-epoch without one);
relaunching the same command resumes from the `.resume` slot.
"""

from __future__ import annotations

import argparse

from ssl4gie_tpu_torch.core.config import (Architecture, DataConfig,
                                           PretrainConfig, RuntimeConfig,
                                           SSLFramework)
from ssl4gie_tpu_torch.core.mesh import maybe_init_distributed
from ssl4gie_tpu_torch.core.preempt import REQUEUE_EXIT_CODE, Preempted
from ssl4gie_tpu_torch.ssl.pretrain import run_pretraining

MAE_ARCHS = (Architecture.VIT_B, Architecture.VIT_L, Architecture.VIT_H)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--framework", type=str, required=True,
                   choices=["mae", "mocov3"])
    p.add_argument("--architecture", "--arch", type=str, default="vit_b",
                   choices=["resnet50", "vit_b", "vit_s", "vit_conv_s",
                            "vit_conv_b", "vit_l", "vit_h"],
                   dest="architecture")
    p.add_argument("--data-root", type=str, default="", dest="data_root")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--warmup-epochs", type=int, default=40,
                   dest="warmup_epochs")
    p.add_argument("--batch-size", type=int, default=768, dest="batch_size")
    p.add_argument("--blr", type=float, default=None,
                   help="base LR (x batch/256); default 1.5e-4 MAE / "
                        "1.5e-4 MoCo-AdamW")
    p.add_argument("--weight-decay", type=float, default=None,
                   dest="weight_decay")
    p.add_argument("--mask-ratio", type=float, default=0.75,
                   dest="mask_ratio")
    p.add_argument("--no-norm-pix-loss", action="store_true",
                   dest="no_norm_pix")
    p.add_argument("--moco-m", type=float, default=0.99, dest="moco_m")
    p.add_argument("--moco-t", type=float, default=0.2, dest="moco_t")
    p.add_argument("--optimizer", type=str, default=None,
                   choices=["adamw", "lars"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   dest="compute_dtype")
    p.add_argument("--ckpt-dir", type=str, default="Pretrained models",
                   dest="ckpt_dir")
    p.add_argument("--save-every", type=int, default=None, dest="save_every",
                   help="retained-checkpoint interval in epochs (default: "
                        "MAE 20 like main_pretrain.py:197, MoCo 1 like "
                        "main_moco.py:310)")
    p.add_argument("--keep-last", type=int, default=0, dest="keep_last",
                   help="prune retained checkpoints to the newest N "
                        "(0 = keep all, the reference behavior)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensor-parallel", "--tp", type=int, default=1,
                   dest="tensor_parallel",
                   help="Megatron-style tensor parallelism over this many "
                        "GPUs (ViT archs; must divide every head count)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP2: shard parameters, gradients and optimizer "
                        "state over the data-parallel ranks")
    p.add_argument("--remat", action="store_true",
                   help="recompute MAE block activations in the backward "
                        "(torch.utils.checkpoint; memory lever for "
                        "vit_l/vit_h)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where to run: the card (default) or the CPU")
    return p


def to_pretrain_config(p: argparse.ArgumentParser,
                       args: argparse.Namespace) -> PretrainConfig:
    """The JAX CLI's checks (`p.error`) and recipe defaults: MAE blr
    1.5e-4, wd 0.05 (main_pretrain.py); MoCo ViT AdamW 1.5e-4, wd 0.1;
    MoCo RN50 LARS 0.3, wd 1.5e-6 (main_moco.py:81-104)."""
    fw = SSLFramework(args.framework)
    arch = Architecture(args.architecture)
    if args.remat and fw != SSLFramework.MAE:
        p.error("--remat applies to MAE pretraining only")
    if fw == SSLFramework.MAE and arch not in MAE_ARCHS:
        p.error("MAE pretraining takes vit_b/vit_l/vit_h "
                "(`Models/mae/models_mae.py:223-250`; the MoCo ViT variants "
                "are mocov3-specific, `Models/moco_v3/vits.py`)")
    if fw == SSLFramework.MOCOV3 and arch in (Architecture.VIT_L,
                                               Architecture.VIT_H):
        p.error("vit_l/vit_h are MAE size presets; MoCo v3 takes "
                "resnet50/vit_s/vit_b/vit_conv_s/vit_conv_b")
    if fw == SSLFramework.MAE:
        blr = args.blr or 1.5e-4
        wd = args.weight_decay if args.weight_decay is not None else 0.05
        opt = "adamw"
    elif arch != Architecture.RESNET50:     # every MoCo ViT: the AdamW recipe
        blr = args.blr or 1.5e-4
        wd = args.weight_decay if args.weight_decay is not None else 0.1
        opt = args.optimizer or "adamw"
    else:
        blr = args.blr or 0.3
        wd = args.weight_decay if args.weight_decay is not None else 1.5e-6
        opt = args.optimizer or "lars"
    return PretrainConfig(
        framework=fw, architecture=arch, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, base_lr=blr, weight_decay=wd,
        batch_size=args.batch_size, mask_ratio=args.mask_ratio,
        norm_pix_loss=not args.no_norm_pix, moco_momentum=args.moco_m,
        moco_temperature=args.moco_t, optimizer=opt,
        save_every=args.save_every, keep_last=args.keep_last,
        model_kwargs={"remat": True} if args.remat else {},
        data=DataConfig(data_root=args.data_root, synthetic=args.synthetic),
        runtime=RuntimeConfig(seed=args.seed,
                              compute_dtype=args.compute_dtype,
                              tensor_parallel=args.tensor_parallel,
                              fsdp=args.fsdp, device=args.device),
        ckpt_dir=args.ckpt_dir)


def run(cfg: PretrainConfig) -> str:
    """Pretrain; a preemption exits with REQUEUE_EXIT_CODE."""
    try:
        path = run_pretraining(cfg)
    except Preempted:
        raise SystemExit(REQUEUE_EXIT_CODE)
    print(f"pretrained encoder checkpoint: {path}")
    return path


def main(argv=None) -> str:
    p = build_parser()
    args = p.parse_args(argv)
    maybe_init_distributed(args.device)
    return run(to_pretrain_config(p, args))


if __name__ == "__main__":
    main()
