"""Card tests of the detection driver and the exact warp (marked `gpu`:
skipped without a card; on the GPU machine run with `--noconftest`, which
needs no JAX): one `DetectionTrainer` epoch through `build_trainer` with
exact kernel launch counts, and the exact classification step, which
launches no rotation kernel and whose warp on the card equals the CPU's."""

import argparse

import pytest
import torch

from ssl4gie_tpu_torch.cli import args as targs
from ssl4gie_tpu_torch.core.trainer import TaskDefinition, make_full_step
from ssl4gie_tpu_torch.core.train_state import make_adamw
from ssl4gie_tpu_torch.data import augment as taug
from ssl4gie_tpu_torch.kernels import dense_attention as da
from ssl4gie_tpu_torch.kernels import flash_attention as fa
from ssl4gie_tpu_torch.kernels import rotate as rot
from ssl4gie_tpu_torch.kernels import window_attention as wa
from ssl4gie_tpu_torch.metrics.classification import weighted_cross_entropy
from ssl4gie_tpu_torch.models.vit import ViTClassifier
from ssl4gie_tpu_torch.tasks import build as tbuild

COUNTERS = {"dense_fwd": da.attention_fwd, "dense_bwd": da.attention_bwd,
            "rotate": rot.shear_rotate,
            "window_fwd": wa.window_attention_fwd,
            "window_bwd": wa.window_attention_bwd,
            "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


@pytest.mark.gpu
def test_detection_trainer_epoch_launch_counts(cuda, tmp_path):
    """`build_trainer` for `--task detection --synthetic` (full ViT-B on the
    256 px canvas, bf16, B = 4, 8 images a split): one epoch of 2 steps and
    8 eval batches launches 8 window forwards per step and per eval batch
    and 8 backwards per step; the 4 global blocks attend over 256 tokens,
    which the packed-QKV kernel takes (the JAX package routes 160 <= N <=
    512 there): 4 forwards per step and per eval batch, 4 backwards per
    step; nothing else; finite mAP."""
    p = argparse.ArgumentParser()
    targs.add_common(p)
    targs.add_train(p)
    cfg = targs.to_train_config(p.parse_args(
        ["--task", "detection", "--arch", "vit_b", "--synthetic",
         "--batch-size", "4", "--epochs", "1", "--ckpt-dir", str(tmp_path)]))
    cfg.data.synthetic_size = 8
    trainer = tbuild.build_trainer(cfg)
    before = _counts()
    best = trainer.fit()
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _counts().items()}
    steps, evals = 2, 8
    assert ran == {"dense_fwd": 4 * (steps + evals), "dense_bwd": 4 * steps,
                   "rotate": 0, "window_fwd": 8 * (steps + evals),
                   "window_bwd": 8 * steps, "flash_fwd": 0, "flash_bwd": 0}
    assert best is not None and 0.0 <= best <= 1.0
    assert trainer.ckpt.exists()


@pytest.mark.gpu
def test_exact_classification_step_launches_no_rotation(cuda):
    """The exact full step (full ViT-B/16, B = 4): 12 + 12 attention
    launches and no rotation; the warp of a bf16 batch on the card equals
    the CPU's at the same matrix, element for element."""
    model = ViTClassifier(6, dtype=torch.bfloat16, device=cuda,
                          generator=torch.Generator().manual_seed(0))
    task = TaskDefinition(name="classification", aug_mode="classification",
                          target_key="label",
                          loss_fn=weighted_cross_entropy)
    img = torch.randint(0, 256, (4, 224, 224, 3), dtype=torch.uint8,
                        device=cuda)
    labels = torch.randint(0, 6, (4,), device=cuda)
    before = _counts()
    loss = make_full_step(task, exact=True)(
        model, make_adamw(model.parameters(), 1e-4), img, labels,
        torch.Generator().manual_seed(0))["loss"]
    assert torch.isfinite(loss)
    ran = {k: v - before[k] for k, v in _counts().items()}
    assert ran["rotate"] == 0
    assert ran["dense_fwd"] == ran["dense_bwd"] == 12
    x = torch.randn((4, 224, 224, 3), device=cuda).to(torch.bfloat16)
    m = taug.rotation_matrix(torch.tensor([-179.0, -45.0, 33.3, 90.0]))
    out = taug.affine_sample(x, m.to(cuda), 0.0, "nearest").cpu()
    assert torch.equal(out, taug.affine_sample(x.cpu(), m, 0.0,
                                                  "nearest"))
