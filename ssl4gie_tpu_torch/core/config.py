"""Typed configuration of the finetune tasks (port of
`ssl4gie_tpu/core/config.py`).

The enums, `validate_combination` and the three config groups are the JAX
package's, field for field, so that one command line gives the same
fields in both packages. `RuntimeConfig.device` is the port's own: the
card (`cuda`) unless the caller asks for the CPU. `tensor_parallel`,
`fsdp`, `mesh_shape` and `mesh_axes` lay out the ranks of a multi-GPU
run (`tasks/build.py:make_run_mesh`, `parallel/tp.py`). Every option
runs on the card, `--compute-dtype float32` included (`compute_dtype`
sets the float32 policy). `RuntimeConfig.scan_steps` and
`donate_state` are read by nothing: the port's loops run one step at a
time and torch has no buffer donation.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Architecture(str, enum.Enum):
    RESNET50 = "resnet50"
    VIT_B = "vit_b"
    # MoCo v3 and MAE pretrain-only presets; the downstream tasks take only
    # vit_b and resnet50
    VIT_S = "vit_s"
    VIT_CONV_S = "vit_conv_s"
    VIT_CONV_B = "vit_conv_b"
    VIT_L = "vit_l"
    VIT_H = "vit_h"


class Pretraining(str, enum.Enum):
    HYPERKVASIR = "Hyperkvasir"          # SSL on Hyperkvasir-unlabelled
    IMAGENET_CLASS = "ImageNet_class"    # supervised ImageNet weights
    IMAGENET_SELF = "ImageNet_self"      # SSL on ImageNet
    RANDOM = "random"                    # random init


class SSLFramework(str, enum.Enum):
    BARLOWTWINS = "barlowtwins"
    MOCOV3 = "mocov3"
    MAE = "mae"


class Task(str, enum.Enum):
    CLASSIFICATION = "classification"
    SEGMENTATION = "segmentation"
    DETECTION = "detection"
    DEPTH = "depth"


def validate_combination(task: Task, arch: Architecture,
                         pretraining: Pretraining,
                         framework: Optional[SSLFramework]) -> None:
    """The reference's valid (task, architecture, pretraining, framework)
    combinations, as the JAX package checks them."""
    if arch not in (Architecture.RESNET50, Architecture.VIT_B):
        raise ValueError(
            f"architecture={arch.value} is MoCo-v3-pretrain-only; downstream "
            "tasks support resnet50 / vit_b")
    if pretraining in (Pretraining.HYPERKVASIR, Pretraining.IMAGENET_SELF):
        if framework is None:
            raise ValueError(
                f"pretraining={pretraining.value} requires --ss-framework "
                "(barlowtwins|mocov3|mae)")
        if framework == SSLFramework.MAE and arch != Architecture.VIT_B:
            raise ValueError("MAE pretraining is ViT-only")
        if (framework == SSLFramework.BARLOWTWINS
                and arch != Architecture.RESNET50):
            raise ValueError("Barlow Twins pretraining is ResNet50-only")
    elif framework is not None:
        raise ValueError(
            f"--ss-framework is only valid with Hyperkvasir/ImageNet_self "
            f"pretraining, got pretraining={pretraining.value}")


@dataclasses.dataclass
class DataConfig:
    dataset: str = ""                  # Kvasir | CVC | C3VD | Hyperkvasir-labelled
    data_root: str = ""
    batch_size: int = 16
    num_workers: int = 8
    img_size: int = 224
    synthetic: bool = False            # synthetic data (no files needed)
    synthetic_size: int = 64           # samples in each synthetic split


@dataclasses.dataclass
class OptimConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    use_plateau_scheduler: bool = True
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    min_lr: float = 1e-6
    accum_steps: int = 1
    grad_clip: Optional[float] = None
    layer_decay: Optional[float] = None
    mixup: float = 0.0
    cutmix: float = 0.0
    label_smoothing: float = 0.0
    drop_path: float = 0.0
    auto_augment: Optional[str] = None
    reprob: float = 0.0
    # torch AdamW's defaults, which the reference inherits
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    adamw_weight_decay: float = 1e-2


@dataclasses.dataclass
class RuntimeConfig:
    seed: int = 42
    mesh_shape: Optional[tuple] = None
    mesh_axes: tuple = ("data",)
    tensor_parallel: int = 1
    fsdp: bool = False
    compute_dtype: str = "bfloat16"    # bf16 compute over f32 masters
    donate_state: bool = True
    log_every: int = 10
    profile_dir: Optional[str] = None
    tensorboard: bool = False
    scan_steps: int = 8
    device: str = "cuda"               # "cpu" only when asked for


def float32_policy() -> None:
    """The port's float32 policy on the card, for every compute dtype:
    float32 products in full float32 and repeatable. The port is held to
    the JAX package's float32 on the CPU (1e-3 of the largest value under
    `--compute-dtype float32`), which cuDNN's TF32 convolutions (a 10-bit
    mantissa, errors near 1e-3 relative; on unless told otherwise) would
    not meet for the RN50 convolutions and DeepLabV3+'s float32
    `seg_head`; matrix products are full float32 by default, stated here
    too. cuDNN's deterministic algorithms keep a rerun (or a resume) bitwise
    equal: its default float32 weight-gradient algorithm for the ViT's
    patch projection sums in another order from run to run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def compute_dtype(runtime: RuntimeConfig) -> torch.dtype:
    """The torch dtype of `runtime.compute_dtype`, the float32 policy
    (`float32_policy`) set: what `build_trainer`, `build_pretraining` and
    `cli.evaluate` call."""
    float32_policy()
    return (torch.bfloat16 if runtime.compute_dtype == "bfloat16"
            else torch.float32)


@dataclasses.dataclass
class TrainConfig:
    task: Task = Task.CLASSIFICATION
    architecture: Architecture = Architecture.VIT_B
    pretraining: Pretraining = Pretraining.RANDOM
    ss_framework: Optional[SSLFramework] = None
    checkpoint: Optional[str] = None
    frozen: bool = False               # train the head/decoder only
    probe: bool = False
    epochs: int = 50
    out_token: str = "cls"             # cls | spatial | global_pool
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    ckpt_dir: str = "Trained models"
    log_dir: str = "Trained models"

    def validate(self) -> "TrainConfig":
        validate_combination(self.task, self.architecture, self.pretraining,
                             self.ss_framework)
        if (self.task == Task.DETECTION
                and self.architecture == Architecture.VIT_B):
            self.data.img_size = 1024
        if self.probe:
            if self.task != Task.CLASSIFICATION:
                raise ValueError("--probe is a linear-classification "
                                 "protocol (main_lincls.py / "
                                 "main_linprobe.py)")
            if self.ss_framework not in (SSLFramework.MOCOV3,
                                         SSLFramework.MAE):
                raise ValueError("--probe requires --ss-framework mocov3 or "
                                 "mae")
        if ((self.optim.auto_augment or self.optim.reprob > 0
             or self.optim.drop_path > 0)
                and self.task != Task.CLASSIFICATION):
            raise ValueError("--aa/--reprob/--drop-path apply to "
                             "classification finetuning only")
        return self

    def run_name(self) -> str:
        """Checkpoint/log base name, the reference's scheme
        (`train_classification.py:203-208`):
        {arch}-{pretraining}[_{ssf}]_init-frozen_{frozen}-dataset_{dataset}
        """
        pre = self.pretraining.value
        if self.ss_framework is not None:
            pre = f"{pre}_{self.ss_framework.value}"
        return (f"{self.architecture.value}-{pre}_init-frozen_{self.frozen}"
                f"-dataset_{self.data.dataset}")


@dataclasses.dataclass
class PretrainConfig:
    """SSL pretraining config (MoCo v3 / MAE on Hyperkvasir-unlabelled),
    the JAX package's fields and defaults."""
    framework: SSLFramework = SSLFramework.MAE
    architecture: Architecture = Architecture.VIT_B
    epochs: int = 400
    warmup_epochs: int = 40
    base_lr: float = 1.5e-4            # MAE blr; scaled by batch/256
    weight_decay: float = 0.05
    batch_size: int = 768
    img_size: int = 224
    mask_ratio: float = 0.75           # MAE
    norm_pix_loss: bool = True         # MAE
    moco_dim: int = 256
    moco_mlp_dim: int = 4096
    moco_momentum: float = 0.99
    moco_temperature: float = 0.2
    moco_stop_grad_patch_embed: bool = True   # --stop-grad-conv1 (ViT recipe)
    optimizer: str = "adamw"           # adamw | lars
    # retained numbered checkpoints every `save_every` epochs (None: MoCo
    # every epoch, `main_moco.py:310-316`; MAE every 20 and the last,
    # `main_pretrain.py:197`); keep_last prunes to the newest N (0: keep
    # all, the reference's behaviour)
    save_every: Optional[int] = None
    keep_last: int = 0
    # MAE size overrides and remat, MoCo stage_sizes (tests narrow models)
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    ckpt_dir: str = "Pretrained models"

    def effective_lr(self) -> float:
        """The base learning rate scaled by batch / 256."""
        return self.base_lr * self.batch_size / 256.0
