"""The train step (port of `ssl4gie_tpu/core/trainer.py:make_train_step`).

One step is the forward, the loss, the backward over `accum_steps`
microbatches with averaged gradients (a Python loop where the JAX package
scans), then the optimizer step. The model runs in train mode: BatchNorm
statistics update once per microbatch, as the JAX package threads its
batch_stats through the scan, and dropout and stochastic depth draw from
the step's generator. `make_full_step` composes the on-device augmentation
(classification, segmentation or depth) and that step, as the JAX
package's bench steps do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ssl4gie_tpu_torch.core.train_state import apply_gradients
from ssl4gie_tpu_torch.data.augment import (apply_classification, apply_depth,
                                            apply_segmentation,
                                            sample_classification_params,
                                            sample_depth_params,
                                            sample_segmentation_params)


@dataclasses.dataclass
class TaskDefinition:
    """What a task contributes to the train step. (The JAX package's
    evaluation and selection fields come with the ported Trainer.)"""
    name: str
    aug_mode: str                       # classification | segmentation | depth
    target_key: str                     # label | mask | depth
    loss_fn: Callable                   # (outputs, targets) -> scalar loss


def make_train_step(task: TaskDefinition, accum_steps: int = 1):
    """Returns train_step(model, optimizer, batch, generator=None) ->
    {"loss": scalar tensor}. `batch` holds "image" and `task.target_key`
    with the batch on dim 0, divisible by `accum_steps`; `generator` drives
    any sampling inside the model (stochastic depth, dropout)."""

    def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   batch: dict, generator: torch.Generator | None = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images, targets = batch["image"], batch[task.target_key]
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        mb = images.shape[0] // accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32, device=images.device)
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss = task.loss_fn(model(images[sl], generator), targets[sl])
            loss.backward()        # sums the microbatch gradients
            loss_sum += loss.detach()
        if accum_steps > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        apply_gradients(optimizer)
        return {"loss": loss_sum / accum_steps}

    return train_step


def make_full_step(task: TaskDefinition, accum_steps: int = 1):
    """Returns full_step(model, optimizer, img_u8, targets, generator):
    sample the augmentation from `generator`, augment the uint8 batch (and,
    for segmentation and depth, its (B, H, W, 1) mask or depth map with it)
    on its device, then take one train step, whose dropout also draws from
    `generator`."""
    if task.aug_mode not in ("classification", "segmentation", "depth"):
        raise NotImplementedError(f"aug_mode {task.aug_mode!r}: only "
                                  "classification, segmentation and depth "
                                  "are ported")
    step = make_train_step(task, accum_steps)

    def full_step(model, optimizer, img_u8, targets, generator):
        B = img_u8.shape[0]
        if task.aug_mode == "segmentation":
            params = sample_segmentation_params(B, img_u8.shape[1], generator)
            img, targets = apply_segmentation(img_u8, targets, params)
        elif task.aug_mode == "depth":
            params = sample_depth_params(B, generator)
            img, targets = apply_depth(img_u8, targets, params)
        else:
            params = sample_classification_params(B, generator)
            img = apply_classification(img_u8, params)
        return step(model, optimizer, {"image": img, task.target_key: targets},
                    generator)

    return full_step
