"""Segmentation task wiring (the segmentation branch of
`ssl4gie_tpu/tasks/build.py:make_task_definition`): the soft Dice loss on
the (B, H, W, 1) mask, the seg augmentation, the head's dropout drawn from
the step's generator (DPT's Dropout(0.1), DeepLabV3+'s ASPP Dropout(0.5)),
and the evaluation by per-image Dice (`dice_pair`), selected on the
maximum."""

from __future__ import annotations

from ssl4gie_tpu_torch.core.trainer import TaskDefinition
from ssl4gie_tpu_torch.metrics.segmentation import dice_pair, soft_dice_loss


def segmentation_task() -> TaskDefinition:
    return TaskDefinition(name="segmentation", aug_mode="segmentation",
                          target_key="mask", loss_fn=soft_dice_loss,
                          eval_metric_fn=dice_pair, select_mode="max",
                          has_dropout=True)
