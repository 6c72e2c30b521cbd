"""Host-side schedules (port of `ssl4gie_tpu/core/schedule.py`).

`ReduceLROnPlateau` is a behavioural match of `torch.optim.lr_scheduler.ReduceLROnPlateau` as the
reference uses it (factor 0.5, patience 10, min_lr 1e-6, mode max or min,
stepped once per epoch on the validation metric,
`train_classification.py:287-310`), kept as the JAX package's copy so that
its state round-trips through the port's checkpoint meta. The Trainer
writes the LR it returns into every param group. The cosine helpers of
pretraining are in `ssl/pretrain.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

_f32 = np.float32


@dataclasses.dataclass
class ReduceLROnPlateau:
    mode: str = "max"                 # 'max' for Dice/F1/mAP, 'min' for depth
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 1e-6
    threshold: float = 1e-4           # torch's default, rel mode
    best: Optional[float] = None
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed one epoch's validation metric; return the (possibly
        reduced) LR."""
        if self.best is None or self._better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return lr

    def _better(self, a: float, best: float) -> bool:
        # torch's 'rel' threshold mode
        if self.mode == "max":
            return a > best * (1.0 + self.threshold)
        return a < best * (1.0 - self.threshold)

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = d.get("best")
        self.num_bad_epochs = int(d.get("num_bad_epochs", 0))


def cosine_warmup_lr(step, *, base_lr: float, warmup_steps: int,
                     total_steps: int, min_lr: float = 0.0) -> float:
    """Per-step linear warmup, then half-cosine decay to `min_lr`."""
    s = _f32(step)
    if s < warmup_steps:
        return float(_f32(base_lr) * s / _f32(max(warmup_steps, 1)))
    progress = (s - _f32(warmup_steps)) / _f32(max(total_steps - warmup_steps,
                                                   1))
    return float(_f32(min_lr) + _f32((base_lr - min_lr) * 0.5)
                 * (_f32(1.0) + np.cos(_f32(math.pi) * progress)))


def cosine_momentum(step, *, base_m: float, total_steps: int) -> float:
    """MoCo v3's EMA momentum, rising from `base_m` to 1 along a half
    cosine over `total_steps` (`main_moco.py:431-434`)."""
    s = _f32(step)
    return float(_f32(1.0) - _f32((1.0 - base_m) * 0.5)
                 * (_f32(1.0) + np.cos(_f32(math.pi) * s / _f32(total_steps))))
