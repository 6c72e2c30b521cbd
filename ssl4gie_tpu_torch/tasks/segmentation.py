"""Segmentation task wiring (the segmentation branch of
`ssl4gie_tpu/tasks/build.py:build_task`): the soft Dice loss on the
(B, H, W, 1) mask, the seg augmentation, the head's dropout drawn from the
step's generator. The evaluator (`dice_pair` over padded batches) waits
for the ported Trainer."""

from __future__ import annotations

from ssl4gie_tpu_torch.core.trainer import TaskDefinition
from ssl4gie_tpu_torch.metrics.segmentation import soft_dice_loss


def segmentation_task() -> TaskDefinition:
    return TaskDefinition(name="segmentation", aug_mode="segmentation",
                          target_key="mask", loss_fn=soft_dice_loss)
