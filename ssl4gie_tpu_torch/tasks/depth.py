"""Depth task wiring (the depth branch of
`ssl4gie_tpu/tasks/build.py:make_task_definition`): the scale-and-shift-
invariant loss with its gradient term (alpha 0.1) on the (B, H, W, 1) depth
map, the depth augmentation (jitter, blur, normalize, joint flips), and
the evaluation by the alpha 0 SSI loss (`ssi_eval_pair`), selected on the
minimum. Neither depth model draws anything in the step."""

from __future__ import annotations

import functools

from ssl4gie_tpu_torch.core.trainer import TaskDefinition
from ssl4gie_tpu_torch.metrics.depth import ssi_eval_pair, ssi_loss


def depth_task() -> TaskDefinition:
    return TaskDefinition(name="depth", aug_mode="depth", target_key="depth",
                          loss_fn=functools.partial(ssi_loss, alpha=0.1),
                          eval_metric_fn=ssi_eval_pair, select_mode="min")
