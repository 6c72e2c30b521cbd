"""The MAE pretraining step (port of the MAE part of
`ssl4gie_tpu/ssl/pretrain.py`).

Recipe (`Models/mae/main_pretrain.py:165-200`, `engine_pretrain.py:42-60`):
AdamW with betas (0.9, 0.95) and weight decay 0.05 on the parameters with
more than one dimension (timm's `add_weight_decay`), the base learning rate
scaled by batch / 256, a per-step linear warmup then cosine decay to 0, the
norm-pix loss, and the global gradient norm reported each step.

`make_mae_train_step` is one step on a normalized batch with given masking
noise; `make_mae_full_step` composes the on-device augmentation, the noise
draw and that step, as the JAX package's jitted `train_step` does. The
epoch loop, checkpoints, resume, `UnlabeledSource` and the MoCo v3 half
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ssl4gie_tpu_torch.core.train_state import make_adamw, set_lr
from ssl4gie_tpu_torch.data.ssl_augment import mae_augment, sample_mae_params


@dataclasses.dataclass
class MAEPretrainConfig:
    """The fields of the JAX package's `PretrainConfig` that the MAE step
    reads, with its defaults (`ssl4gie_tpu/core/config.py:194-205`). The
    epoch counts come with the loop."""
    base_lr: float = 1.5e-4            # MAE blr; scaled by batch / 256
    weight_decay: float = 0.05
    batch_size: int = 768
    img_size: int = 224
    mask_ratio: float = 0.75
    norm_pix_loss: bool = True

    def effective_lr(self) -> float:
        return self.base_lr * self.batch_size / 256.0


class SyntheticUnlabeled:
    """Random uint8 canvases (the JAX package's `SyntheticUnlabeled`, same
    numpy draws)."""

    def __init__(self, n: int, canvas: int = 256, seed: int = 0):
        self.n, self.canvas, self.seed = n, canvas, seed

    def __len__(self):
        return self.n

    def get(self, i):
        rng = np.random.default_rng(self.seed * 9973 + i)
        return {"image": rng.integers(0, 256, (self.canvas, self.canvas, 3),
                                      dtype=np.uint8)}

    def batch(self, indices) -> dict:
        """The samples `indices` stacked into numpy arrays."""
        return {"image": np.stack([self.get(i)["image"] for i in indices])}


def wd_mask(p: torch.Tensor) -> bool:
    """MAE's weight-decay grouping: decay only parameters with ndim > 1."""
    return p.ndim > 1


def make_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1), 0), as the JAX package builds it: linear from 0
    over the warmup (step 0 gives 0), then cosine to 0 over the remaining
    decay steps (the decay steps include the warmup). step -> lr."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        t = min(step - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def make_mae_optimizer(model: torch.nn.Module,
                       cfg: MAEPretrainConfig) -> torch.optim.AdamW:
    """optax `adamw(schedule, b1=0.9, b2=0.95, weight_decay, mask=wd_mask)`;
    the step sets the learning rate from the schedule."""
    return make_adamw(model.parameters(), 0.0, b1=0.9, b2=0.95,
                      weight_decay=cfg.weight_decay, decay_mask=wd_mask)


def make_mae_train_step(schedule):
    """Returns train_step(model, optimizer, imgs, noise, step) -> {"loss",
    "grad_norm"}: the MAE loss of the normalized (B, S, S, 3) batch at the
    masking noise (B, L), its backward, and one AdamW step at the schedule's
    learning rate for `step` (0-based: the first step runs at schedule(0),
    as optax counts)."""

    def train_step(model, optimizer, imgs, noise, step: int):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _, _ = model(imgs, noise)
        loss.backward()
        # optax.global_norm: the norm of all (float32) gradients together
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        set_lr(optimizer, schedule(step))
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_mae_full_step(schedule, img_size: int = 224):
    """Returns full_step(model, optimizer, img_u8, generator, step): draw
    the crop boxes, flips and masking noise from `generator` (on its
    device), run `mae_augment` on the uint8 (B, canvas, canvas, 3) batch,
    then take one train step."""
    step_fn = make_mae_train_step(schedule)

    def full_step(model, optimizer, img_u8, generator, step: int):
        B = img_u8.shape[0]
        params = sample_mae_params(B, generator, canvas=img_u8.shape[1])
        imgs = mae_augment(img_u8, params, out_size=img_size)
        noise = model.draw_noise(B, generator)
        return step_fn(model, optimizer, imgs, noise, step)

    return full_step
