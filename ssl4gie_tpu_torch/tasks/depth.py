"""Depth task wiring (the depth branch of
`ssl4gie_tpu/tasks/build.py:build_task`): the scale-and-shift-invariant
loss with its gradient term (alpha 0.1) on the (B, H, W, 1) depth map, the
depth augmentation (jitter, blur, normalize, joint flips). Neither depth
model draws anything in the step. The evaluator (`ssi_eval_pair` over
padded batches, selection on the minimum) waits for the ported Trainer."""

from __future__ import annotations

import functools

from ssl4gie_tpu_torch.core.trainer import TaskDefinition
from ssl4gie_tpu_torch.metrics.depth import ssi_loss


def depth_task() -> TaskDefinition:
    return TaskDefinition(name="depth", aug_mode="depth", target_key="depth",
                          loss_fn=functools.partial(ssi_loss, alpha=0.1))
