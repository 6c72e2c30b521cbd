"""Host-side plateau LR schedule (port of `ReduceLROnPlateau` in
`ssl4gie_tpu/core/schedule.py`).

A behavioural match of `torch.optim.lr_scheduler.ReduceLROnPlateau` as the
reference uses it (factor 0.5, patience 10, min_lr 1e-6, mode max or min,
stepped once per epoch on the validation metric,
`train_classification.py:287-310`), kept as the JAX package's copy so that
its state round-trips through the port's checkpoint meta. The Trainer
writes the LR it returns into every param group. The cosine helpers of
pretraining are in `ssl/pretrain.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
